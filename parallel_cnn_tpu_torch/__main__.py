from parallel_cnn_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
