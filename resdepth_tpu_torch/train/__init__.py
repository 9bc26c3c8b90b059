"""Training: loss, optimizers, train and eval steps, checkpoints, Trainer,
and the CLI ``python -m resdepth_tpu_torch.train cfg.json`` (``cli.py``)."""


def main(argv=None):
    """The train CLI (``train/cli.py``); returns the finished Trainer."""
    from resdepth_tpu_torch.train.cli import main as run
    return run(argv)
