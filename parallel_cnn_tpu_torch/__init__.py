"""parallel_cnn_tpu_torch — the PyTorch and CUDA port of parallel_cnn_tpu
for an NVIDIA H100.

The JAX package ``parallel_cnn_tpu`` stays the reference; this package
imports torch and numpy and nothing of JAX or of the JAX package. It keeps
the JAX package's layout so each module's counterpart is easy to find:

- ``ops``      — hand-written CUDA kernels with their plain PyTorch versions
                 (``ops.tap_conv``: the SAME NHWC conv + fused epilogue).
- ``nn``       — layers as ``torch.nn.Module``s: ConvBNAct, BatchNorm,
                 Dense, the pools, the ResNet family, VGG-16.
- ``serve``    — registry, engine, dynamic batcher, telemetry, loadgen,
                 admission, capacity, autoscaler, scenarios.
- ``obs``      — span tracer, event journal, metrics registry.
- ``convert``  — weights and checkpoints written by the JAX package.
- ``utils``    — device resolution, histograms.

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``.
"""

__version__ = "0.1.0"
