"""``resdepth_tpu_torch/graft_entry.py`` (the port of ``__graft_entry__.py``)
on the CPU.

* ``entry()``: the example input is JAX's (same shape, dtype and values),
  and the forward on a 1x64x64x3 input from ``default_rng(0)``, with JAX's
  ``entry()`` weights carried across by ``state_dict_from_jax_params``,
  is JAX's within 1e-5 of the largest output (the f32 forward bar of
  ``test_torch_unet.py``).
* ``dryrun_multichip(2, device="cpu")``: its four legs in a world of 2 gloo
  processes, and ``dryrun_multichip(4, device="cpu")`` with the 2x2
  (dcn, ici) leg; the ranks run in children that cannot import JAX or
  the JAX package. The legs' own bars hold (every rank's weights bitwise
  the others', the tile-sharded scene within K1's 2 ulps of one process,
  the scene-sharded one bitwise off the seam rows and within 2 ulps on
  them).
* A rank that fails, or a world that hangs, fails the dry run and names the
  leg; ``device="cuda"`` without a card, or with fewer cards than ranks and
  no ``share_cards``, raises before any rank starts.
"""

import sys
import time

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from resdepth_tpu_torch import graft_entry
from resdepth_tpu_torch.models import weights

BLOCK_JAX = ("import sys\n"
             "class B:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('jax', 'jaxlib', 'resdepth_tpu'):\n"
             "            raise ImportError(name + ': the port must not import JAX')\n"
             "sys.meta_path.insert(0, B())\n"
             "import runpy\n"
             "runpy.run_module('resdepth_tpu_torch.graft_entry', run_name='__main__')\n")
RANK_ARGV = [sys.executable, "-c", BLOCK_JAX, "--rank"]


def test_entry_is_jax_entry():
    fn, (model, x) = graft_entry.entry("cpu")
    jfn, (params, bn_state, jx) = jentry.entry()
    assert x.shape == jx.shape == (4, 256, 256, 3) and x.dtype == jx.dtype == np.float32
    np.testing.assert_array_equal(x, jx)
    assert not model.training and model.device == torch.device("cpu")
    model.load_state_dict(weights.state_dict_from_jax_params(params, bn_state,
                                                             model.config))
    small = np.random.default_rng(0).normal(size=(1, 64, 64, 3)).astype(np.float32)
    got = fn(model, small)
    want = np.asarray(jax.jit(jfn)(params, bn_state, small))
    assert got.shape == want.shape == (1, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_on_the_cpu(n, capsys):
    results = graft_entry.dryrun_multichip(n, device="cpu", rank_argv=RANK_ARGV)
    printed = capsys.readouterr().out
    names = ["train", "banded", "tile-sharded", "scene-sharded"] + (
        ["train-2d"] if n == 4 else [])
    assert graft_entry.legs(n) == names
    assert [r["rank"] for r in results] == list(range(n))
    for name in names:
        assert f"dryrun_multichip({n}) [{n} gloo processes on the CPU]: {name}" in printed
    legs = results[0]["legs"]
    assert legs["train"]["step"] == 1 and np.isfinite(legs["train"]["metric"])
    assert legs["banded"]["windows"] >= 2 and legs["banded"]["step"] == 2
    assert legs["tile-sharded"]["bar"] == 2
    assert max(legs["tile-sharded"]["ulps"].values()) <= 2
    assert legs["scene-sharded"]["seam_ulps"] <= graft_entry.SEAM_ULPS
    assert [r["legs"]["scene-sharded"]["holds_scene"] for r in results] == \
        [True] + [False] * (n - 1)
    if n == 4:
        assert "2x2 (dcn, ici) mesh" in printed
        assert legs["train-2d"]["digest"] == legs["train"]["digest"]
    # on the CPU the plain versions run: no kernel launched
    assert all(v == 0 for r in results for leg in r["legs"].values()
               for v in leg["launches"].values())


@pytest.mark.parametrize("argv,timeout,message", [
    ([sys.executable, "-c", "import sys; sys.exit(3)"], 60, "exit 3"),
    ([sys.executable, "-c", "import time; time.sleep(600)"], 3, "outlasted 3 s")],
    ids=["rank-fails", "world-hangs"])
def test_dryrun_fails_a_leg_without_hanging(argv, timeout, message):
    start = time.monotonic()
    with pytest.raises(RuntimeError, match=message) as info:
        graft_entry.dryrun_multichip(2, device="cpu", rank_argv=argv, timeout=timeout)
    assert "leg 'train' failed" in str(info.value)
    assert time.monotonic() - start < timeout + 30


def test_cuda_without_enough_cards_raises(monkeypatch):
    """Never a silent fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="1 visible card"):
        graft_entry.dryrun_multichip(2, rank_argv=["false"])
