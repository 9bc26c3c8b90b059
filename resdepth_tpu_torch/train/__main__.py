"""``python -m resdepth_tpu_torch.train cfg.json [--device {cuda,cpu}]``."""

from resdepth_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
