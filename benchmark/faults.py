"""Faults planted underneath a run's timed path, each a context manager
that breaks one part of the program while the block runs: the checks of
``correct`` have to catch every fault a cell can have
(``tests/test_bench_faults.py``, and ``readings.py --fault`` for a fault's
reading at a cell's own size).

Serving and the CLI: ``unchanged`` (the stitch adds nothing), ``half_batch`` (only
the first half of each batch is stitched), ``altered`` (one tile of each
batch is shifted by a DSM standard deviation where it is produced). The
CLI also: ``statistic`` (``evaluate_performance`` reports every class's
median residual 1 cm off). Training: ``unchanged`` (the step leaves the
weights and BatchNorm's running statistics as they are), ``half_batch``
(the loss is the mean over the first half of each batch). A one-chip cell
has no exchange between chips to leave out."""

from __future__ import annotations

from benchmark.harness import wrapped


def _stitch(kind):
    def make(name, stitch_tiles):
        def broken(scene, tiles, positions, wy, wx, means, sigma, **kwargs):
            if kind == "unchanged":
                return scene
            if kind == "half_batch":
                half = tiles.shape[0] // 2
                return stitch_tiles(scene, tiles[:half], positions[:half], wy[:half],
                                    wx[:half], means[:half], sigma, **kwargs)
            tiles = tiles.clone()
            tiles[0] += 1.0
            return stitch_tiles(scene, tiles, positions, wy, wx, means, sigma, **kwargs)
        return broken
    return make


def _loss_half_batch(name, loss_fn):
    def half(pred, target, loss_mask, dsm_mean, dsm_std, sample_weights=None, group=None):
        n = pred.shape[0] // 2
        return loss_fn(pred[:n], target[:n], loss_mask[:n], dsm_mean[:n], dsm_std,
                       None if sample_weights is None else sample_weights[:n], group)
    return half


def _state_unchanged(name, fn):
    if name == "commit_bn_state":
        return lambda *args, **kwargs: None

    def init(*args, **kwargs):
        state = fn(*args, **kwargs)
        state.optimizer.step = lambda *a, **k: None
        return state
    return init


def _statistic_off(name, get_statistics):
    def off(*args, **kwargs):
        stats = get_statistics(*args, **kwargs)
        stats.median = stats.median + 0.01
        return stats
    return off


SERVE = ("unchanged", "half_batch", "altered")
TRAIN = ("unchanged", "half_batch")
#: The faults each driver's cells can have.
OF_DRIVER = {"serve_resident": SERVE, "cli_scene": SERVE + ("statistic",),
             "train_epochs": TRAIN}


def planted(driver: str, kind: str):
    """The fault ``kind`` for a traffic's ``driver``."""
    if kind == "statistic":
        from resdepth_tpu_torch.evaluation import performance
        return wrapped([(performance, "get_statistics")], _statistic_off)
    if driver in ("serve_resident", "cli_scene"):
        from resdepth_tpu_torch.ops import stitch
        return wrapped([(stitch, "stitch_tiles")], _stitch(kind))
    from resdepth_tpu_torch.train import step
    if kind == "unchanged":
        return wrapped([(step, "init_train_state"), (step, "commit_bn_state")],
                       _state_unchanged)
    return wrapped([(step, "denormalized_masked_l1")], _loss_half_batch)
