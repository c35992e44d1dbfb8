"""Data for the trainers: MNIST idx files, the synthetic stand-ins, epoch
order, zoo augmentation (the port's copy of ``parallel_cnn_tpu/data``)."""

from parallel_cnn_tpu_torch.data.mnist import (  # noqa: F401
    MnistError,
    load_idx_images,
    load_idx_labels,
    load_pair,
    write_idx_images,
    write_idx_labels,
)
from parallel_cnn_tpu_torch.data.pipeline import (  # noqa: F401
    Dataset,
    epoch_batches,
    load_split,
    load_train_test,
    native_semantics_batches,
    pad_to_batch,
)
from parallel_cnn_tpu_torch.data.synthetic import (  # noqa: F401
    make_dataset,
    make_image_dataset,
)
