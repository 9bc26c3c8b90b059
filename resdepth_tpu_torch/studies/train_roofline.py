"""Train-step roofline on one H100: the samples/s ceiling the card allows,
and how close the port's step runs to it (the port's copy of
``scripts/train_roofline.py``).

    python -m resdepth_tpu_torch.studies.train_roofline
        [--modes balanced16,high] [--batches 20,32] [--measure]
        [--device cuda] [--json OUT.json]

For the flagship geom-stereo train step at each mode and batch:

  1. the analytic compulsory-traffic model of the JAX script, unchanged
     (``materialized_activations``, ``traffic_model``): every activation
     the forward materialises, moved 5 times (written, read by its
     consumer, read again in the backward, and the gradient written and
     read), one optimizer pass over the float32 parameters (10 x 4 bytes a
     parameter) and the input gather; over the card's 3.35 TB/s;
  2. the operation bound: 3x the forward's conv FLOPs
     (``models/unet.py::analytic_flops``) a sample, each conv at the mode's
     work: a layer at p bf16 passes (the port's pass-count modes run the
     forward, dx and dw of such a conv at its passes) costs p x its FLOPs
     at the card's dense bf16 tensor rate (989 TFLOP/s), a bf16 layer one
     pass; ``high`` trains in IEEE float32 with TF32 off, on the CUDA
     cores (67 TFLOP/s);
  3. the practical bound: 4 more activation passes for the BatchNorm
     normalisation and its backward, which eager PyTorch materialises;
     and, with ``--measure``, the achievable operation bound from each
     conv's rate measured on the card at the step's batch
     (``measure_conv_rates``: the forward of each conv as the mode's
     training runs it: K3 at its passes, cuDNN for the rest);
  4. with ``--measure``, the port's step timed on the card
     (``studies/train_throughput_study.py``: 8 steps between CUDA events,
     best of 3 windows) as a share of both ceilings.

Activations are stored in float32 in ``high``, ``default`` and
``balanced`` and in bf16 in ``balanced16`` and ``bf16`` (their bf16
trunk). The JAX script's third column, XLA's post-fusion cost analysis,
has no PyTorch counterpart: its field is null. ``--measure`` needs the
card; the analytic columns need none.
"""

from __future__ import annotations

import argparse
import json

import torch

TILE = 256
PEAK_BF16 = 989e12          # FLOP/s, H100 SXM dense bf16 tensor rate (data sheet)
PEAK_F32 = 67e12            # FLOP/s, H100 SXM float32 outside the tensor cores
HBM_BW = 3.35e12            # bytes/s, H100 SXM HBM3
COST_ANALYSIS_NOTE = ("no PyTorch counterpart of XLA's compiled cost_analysis: "
                      "eager PyTorch compiles no program whose bytes it could report")
MODES = ("high", "default", "balanced", "balanced16", "bf16")


def materialized_activations(config, tile: int) -> int:
    """Elements (per sample) of every tensor the fwd graph materialises in
    HBM: conv/pool/upconv outputs. Mirrors models.unet.analytic_flops's
    topology walk (encoder single-conv levels + pool, bottleneck, decoder
    upconv + post-skip conv, final conv)."""
    widths = config.filter_depths
    t = tile
    elems = 0
    for i, w in enumerate(widths):
        r = t >> i
        elems += r * r * w              # encoder conv output (stashed)
        elems += (r // 2) * (r // 2) * w  # pooled output
    r = t >> config.depth
    elems += r * r * widths[-1]         # bottleneck conv output
    widths_up = tuple(reversed(widths))
    for i in range(config.depth):
        r_out = t >> (config.depth - 1 - i)
        elems += r_out * r_out * widths_up[i]          # upconv output
        if i != config.depth - 1:
            elems += r_out * r_out * widths_up[i + 1]  # post-skip conv out
    elems += t * t                       # final conv output (1 channel)
    return elems


def traffic_model(config, tile: int, batch: int, act_bytes: int) -> dict:
    """Compulsory HBM bytes of ONE fused train step at ``batch``."""
    from resdepth_tpu_torch.models.unet import init_unet, param_count

    acts = materialized_activations(config, tile) * batch
    # fwd: write + consumer read; bwd: re-read stash; grad chain: write+read.
    act_traffic = 5 * acts * act_bytes

    n_params = param_count(init_unet(config, torch.Generator().manual_seed(0)))
    # params read fwd + read bwd (2P), grads write by bwd + read by Adam
    # (2P), fused Adam reads m,v,p and writes m,v,p (6P) — all f32 masters.
    param_traffic = 10 * n_params * 4

    # input pipeline: gather batch x (dsm_in + 2 orthos + target) f32 tiles
    # from the resident rasters + write the assembled/augmented batch.
    input_traffic = 2 * batch * 4 * tile * tile * 4

    return {
        "n_params": n_params,
        "activation_elems_per_sample": materialized_activations(config, tile),
        "act_bytes": act_traffic,
        "param_bytes": param_traffic,
        "input_bytes": input_traffic,
        "total_bytes": act_traffic + param_traffic + input_traffic,
    }


def layer_plan(config, tile: int, mode: str) -> list:
    """Each conv of the training forward as the port runs it at ``mode``:
    name (the JAX layer name), kind (``conv3x3`` or ``up``), output
    resolution, channels in and out, FLOPs a sample, storage dtype and bf16
    passes (None: IEEE float32 on the CUDA cores; 1 for a bf16 layer)."""
    widths = config.filter_depths
    t = tile
    layers = []

    def add(name, kind, r, cin, cout):
        taps = 9 if kind == "conv3x3" else 1
        layers.append({"name": name, "kind": kind, "r": r, "cin": cin, "cout": cout,
                       "flops": 2 * taps * r * r * cin * cout})

    in_ch = config.n_input_channels
    for i, w in enumerate(widths):
        add(f"encoder{i}", "conv3x3", t >> i, in_ch, w)
        in_ch = w
    add("bottleneck", "conv3x3", t >> config.depth, widths[-1], widths[-1])
    widths_up = tuple(reversed(widths))
    for i in range(config.depth):
        r_out = t >> (config.depth - 1 - i)
        add(f"up{i}", "up", r_out, widths_up[i], widths_up[i])
        if i != config.depth - 1:
            add(f"decoder{i}", "conv3x3", r_out, widths_up[i], widths_up[i + 1])
    add("last", "conv3x3", t, config.start_kernel, 1)

    hifi = {"encoder0", "last"}
    for layer in layers:
        if mode == "high":
            layer.update(dtype="float32", passes=None)
        elif mode == "bf16":
            layer.update(dtype="bfloat16", passes=1)
        elif mode == "default":
            layer.update(dtype="float32", passes=1)
        elif mode == "balanced":
            layer.update(dtype="float32", passes=3 if layer["name"] in hifi else 1)
        elif mode == "balanced16":
            layer.update(**({"dtype": "float32", "passes": 3} if layer["name"] in hifi
                            else {"dtype": "bfloat16", "passes": 1}))
        else:
            raise ValueError(f"unknown mode {mode!r}: one of {MODES}")
    return layers


def measure_conv_rates(config, tile: int, batch: int, mode: str, device) -> dict:
    """FLOP/s of each conv of ``layer_plan`` on the card, by name: its
    forward at ``batch`` on random inputs, as ``models/unet.py`` runs it in
    training at ``mode`` (``_conv3x3``: K3 at the layer's passes, cuDNN in
    bf16 or IEEE float32; ``_upconv_at``: ``ops/passes.py`` at the passes,
    cuDNN otherwise), CUDA events over 5 calls after 2."""
    from torch import nn

    from resdepth_tpu_torch.models.unet import Precision, _conv3x3, _upconv_at
    from resdepth_tpu_torch.studies.train_throughput_study import MODES as POLICIES
    from resdepth_tpu_torch.train.step import select_train_precision

    if device.type != "cuda":
        raise ValueError("the conv rates are the card's: run with --device cuda")
    select_train_precision(*POLICIES[mode], device)   # TF32 off, as in the step
    precision = {None: Precision.HIGHEST, 1: Precision.DEFAULT, 3: Precision.HIGH}
    generator = torch.Generator(device=device).manual_seed(0)
    rates = {}
    for layer in layer_plan(config, tile, mode):
        dtype = getattr(torch, layer["dtype"])
        prec = precision[layer["passes"]]
        r_in = layer["r"] if layer["kind"] == "conv3x3" else layer["r"] // 2
        x = torch.randn((batch, layer["cin"], r_in, r_in), generator=generator,
                        device=device).to(dtype)
        if layer["kind"] == "conv3x3":
            w = torch.randn((layer["cout"], layer["cin"], 3, 3), generator=generator,
                            device=device) / (3.0 * layer["cin"] ** 0.5)

            def fn():
                return _conv3x3(x, w, None, prec)
        else:
            module = nn.ConvTranspose2d(layer["cin"], layer["cout"], 2, stride=2).to(device)

            def fn():
                return _upconv_at(module, x, prec)
        with torch.inference_mode():
            for _ in range(2):
                fn()
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                fn()
            end.record()
            end.synchronize()
        seconds = start.elapsed_time(end) / 1e3 / 5
        rates[layer["name"]] = layer["flops"] * batch / seconds
        del x
    torch.cuda.empty_cache()
    return rates


def roofline(config, tile: int, batch: int, mode: str, rates: dict | None = None) -> dict:
    """The bounds of one train step at ``mode`` and ``batch`` (module
    docstring); the achievable ones only with ``rates``
    (``measure_conv_rates``), else None."""
    from resdepth_tpu_torch.models.unet import analytic_flops

    act_bytes = 2 if mode in ("balanced16", "bf16") else 4
    tm = traffic_model(config, tile, batch, act_bytes)
    plan = layer_plan(config, tile, mode)
    flops = 3 * analytic_flops(config, tile) * batch
    if mode == "high":
        tensor_ops = 0
        t_ops = flops / PEAK_F32
    else:
        tensor_ops = 3 * batch * sum(layer["flops"] * layer["passes"] for layer in plan)
        t_ops = tensor_ops / PEAK_BF16
    t_hbm = tm["total_bytes"] / HBM_BW
    # BatchNorm's normalisation (forward read + write) and its backward (two
    # more activation passes) run as separate kernels: +4 activation passes.
    practical_bytes = (tm["total_bytes"]
                       + 4 * tm["activation_elems_per_sample"] * batch * act_bytes)
    t_hbm_practical = practical_bytes / HBM_BW
    t_step = max(t_hbm, t_ops)
    out = {
        "mode": mode, "batch": batch, **tm,
        "flops_per_step": flops,
        "tensor_pass_flops_per_step": tensor_ops,
        "t_hbm_ms": 1e3 * t_hbm,
        "t_ops_ms": 1e3 * t_ops,
        "ops_unit": "CUDA cores f32" if mode == "high" else "tensor cores bf16",
        "bound": "HBM" if t_hbm > t_ops else "operations",
        "ceiling_samples_per_s": batch / t_step,
        "t_hbm_practical_ms": 1e3 * t_hbm_practical,
        "t_ops_achievable_ms": None, "achievable_bound": None,
        "achievable_samples_per_s": None, "conv_rates_tflops": None,
        "xla_cost_analysis": None, "xla_cost_analysis_note": COST_ANALYSIS_NOTE,
    }
    if rates is not None:
        t_achv_ops = sum(3 * batch * layer["flops"] / rates[layer["name"]]
                         for layer in plan)
        out.update(t_ops_achievable_ms=1e3 * t_achv_ops,
                   achievable_bound=("HBM+BN" if t_hbm_practical > t_achv_ops
                                     else "operations at the measured conv rates"),
                   achievable_samples_per_s=batch / max(t_hbm_practical, t_achv_ops),
                   conv_rates_tflops={k: v / 1e12 for k, v in rates.items()})
    return out


def main(argv=None) -> list:
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.models.unet import flagship_config
    from resdepth_tpu_torch.studies.precision_study import device_name
    from resdepth_tpu_torch.studies.train_throughput_study import measure

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--modes", default="balanced16,high")
    p.add_argument("--batches", default="20,32")
    p.add_argument("--measure", action="store_true",
                   help="measure the conv rates and the step on the card")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    modes = args.modes.split(",")
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        p.error(f"unknown --modes {unknown}; valid: {list(MODES)}")
    config = flagship_config("geom-stereo")
    device = predict.resolve_device(args.device) if args.measure else None
    if args.measure and device.type != "cuda":
        p.error("--measure times the card: run it with --device cuda")
    print(f"[roofline] H100 constants: {PEAK_BF16 / 1e12:.0f} TFLOP/s bf16 tensor, "
          f"{PEAK_F32 / 1e12:.0f} TFLOP/s f32 CUDA cores, {HBM_BW / 1e12:.2f} TB/s; "
          f"xla_cost_analysis: null ({COST_ANALYSIS_NOTE})"
          + (f"; measured on {device_name(device)}" if device is not None else ""),
          flush=True)

    results = []
    for mode in modes:
        for batch in (int(b) for b in args.batches.split(",")):
            rates = (measure_conv_rates(config, TILE, batch, mode, device)
                     if args.measure else None)
            r = roofline(config, TILE, batch, mode, rates)
            if args.measure:
                m = measure(config, TILE, mode, batch, False, 8, 3, device)
                r["measured_samples_per_s"] = m["samples_per_sec"]
                r["measured_step_ms"] = m["step_ms"]
                r["pct_of_roofline"] = 100.0 * m["samples_per_sec"] / r[
                    "ceiling_samples_per_s"]
                r["pct_of_achievable"] = 100.0 * m["samples_per_sec"] / r[
                    "achievable_samples_per_s"]
            results.append(r)
            print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                              for k, v in r.items() if k != "conv_rates_tflops"}),
                  flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
