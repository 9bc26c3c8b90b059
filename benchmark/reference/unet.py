"""The ResDepth UNet (Stucker & Schindler, ISPRS J. 2022; prs-eth/ResDepth
``lib/UNet.py``) in plain PyTorch, NCHW, on a ``state_dict`` in the
published layout (``benchmark/inputs/weights.py``).

Per level: a 3x3 conv without bias, BatchNorm, ReLU, then 2x2 max-pool;
the bottleneck's conv block; per decoder level a 2x2 stride-2 transposed
conv with bias, the additive skip and a conv block (none after the top
skip); the last 3x3 conv to one channel, with a bias where the weights
hold one (``bias_conv_layer``); the outer residual adds input channel 0. Run in float32 with TF32 off (``float32_exact``), it is the
yardstick the program's outputs are held to."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


@contextlib.contextmanager
def float32_exact(exact: bool = True):
    """TF32 off for cuDNN convs and matmuls inside the block (on with
    ``exact`` False, for a control)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = not exact
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _batch_norm(x, sd, prefix, train, new_stats):
    if not train:
        return F.batch_norm(x, sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"],
                            sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], False, 0.0,
                            BN_EPS)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    count = x.numel() // x.shape[1]
    with torch.no_grad():
        new_stats[f"{prefix}.running_mean"] = (
            (1 - BN_MOMENTUM) * sd[f"{prefix}.running_mean"] + BN_MOMENTUM * mean)
        new_stats[f"{prefix}.running_var"] = (
            (1 - BN_MOMENTUM) * sd[f"{prefix}.running_var"]
            + BN_MOMENTUM * var * count / (count - 1))
    scale = torch.rsqrt(var + BN_EPS) * sd[f"{prefix}.weight"]
    return ((x - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1)
            + sd[f"{prefix}.bias"].view(1, -1, 1, 1))


def _block(x, sd, prefix, train, new_stats):
    y = F.conv2d(x, sd[f"{prefix}.0.weight"], None, padding=1)
    return F.relu(_batch_norm(y, sd, f"{prefix}.1", train, new_stats))


def forward(sd: dict, x: torch.Tensor, depth: int, *, train: bool = False,
            new_stats: dict | None = None) -> torch.Tensor:
    """``x`` (N, C, H, W), the normalised DSM in channel 0 -> (N, 1, H, W).
    ``train`` normalises by the batch's statistics (biased variance) and
    writes BatchNorm's new running statistics (unbiased variance, momentum
    0.1) into ``new_stats``; otherwise the running statistics serve."""
    skips, out = [], x
    for i in range(depth):
        out = _block(out, sd, f"encoder.{i}.0", train, new_stats)
        skips.append(out)
        out = F.max_pool2d(out, 2)
    out = _block(out, sd, "bottleneck", train, new_stats)
    for i in range(depth - 1):
        up = F.conv_transpose2d(out, sd[f"decoder.{i}.0.weight"],
                                sd[f"decoder.{i}.0.bias"], stride=2)
        out = _block(skips[-1 - i] + up, sd, f"decoder.{i}.1", train, new_stats)
    top = depth - 1
    out = skips[0] + F.conv_transpose2d(out, sd[f"decoder.{top}.weight"],
                                        sd[f"decoder.{top}.bias"], stride=2)
    return F.conv2d(out, sd["last_layer.weight"], sd.get("last_layer.bias"),
                    padding=1) + x[:, :1]
