"""ResDepth's training step (``train.py`` of prs-eth/ResDepth) in plain
PyTorch: the batch gathered from the rasters at the given tile origins,
the DSM and the target centred on the tile's mean DSM over valid pixels
and scaled by the DSM's standard deviation, the orthos normalised, the
loss mask (valid and non-zero ground truth), a dihedral augmentation of
mask, target and input alike (transpose, flip rows, flip columns, each
where its bit is set), the UNet with BatchNorm on the batch's statistics,
the masked L1 in metres, and Adam (``torch.optim.Adam``, L2 weight decay).
In float32 with TF32 off (``unet.float32_exact``)."""

from __future__ import annotations

import torch

from benchmark.reference import unet


def batch(rasters: dict, positions, bits, *, tile: int, dsm_std: float,
          ortho_mean: float, ortho_std: float, nodata: float):
    """``(input NCHW, target, mask)`` of one batch; ``bits`` (3, B) bool."""
    def gather(plane):
        return torch.stack([plane[..., y:y + tile, x:x + tile] for y, x in positions])

    dsm, gt = gather(rasters["dsm"]), gather(rasters["gt"])
    mask = ((gt != nodata) & (gt != 0)).float()
    valid = (dsm != nodata).float()
    mean = (dsm * valid).sum((1, 2)) / valid.sum((1, 2)).clamp_min(1)
    planes = [mask[:, None], ((gt - mean[:, None, None]) / dsm_std)[:, None],
              ((dsm - mean[:, None, None]) / dsm_std)[:, None]]
    if rasters.get("orthos") is not None:
        planes.append((gather(rasters["orthos"]) - ortho_mean) / ortho_std)
    stacked = torch.cat(planes, 1)
    for bit, flip in zip(bits, (lambda t: t.transpose(2, 3), lambda t: t.flip(2),
                                lambda t: t.flip(3))):
        stacked = torch.where(bit.view(-1, 1, 1, 1), flip(stacked), stacked)
    return stacked[:, 2:], stacked[:, 1:2], stacked[:, 0:1]


def train_steps(state: dict, depth: int, batches, *, lr: float, weight_decay: float,
                dsm_std: float, **batch_kwargs) -> dict:
    """Train a copy of ``state`` on ``batches`` (``(positions, bits)``
    each, gathered by ``batch`` from ``batch_kwargs['rasters']``).
    Returns each step's loss, the first step's input to the UNet (NCHW)
    and gradient as Adam takes it (with the weight decay), and the
    parameters and BatchNorm's running statistics after the last step."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state.items()
              if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    buffers = {k: v.clone() for k, v in state.items() if k not in params}
    optimizer = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    losses, first_input, first_grad = [], None, None
    with unet.float32_exact():
        for positions, bits in batches:
            x, target, mask = batch(positions=positions, bits=bits, dsm_std=dsm_std,
                                    **batch_kwargs)
            new_stats: dict = {}
            pred = unet.forward({**params, **buffers}, x, depth, train=True,
                                new_stats=new_stats)
            loss = ((pred - target).abs() * dsm_std * mask).sum() / mask.sum().clamp_min(1)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if first_grad is None:
                first_input = x
                first_grad = {k: (p.grad + weight_decay * p).detach().clone()
                              for k, p in params.items()}
            optimizer.step()
            buffers.update(new_stats)
            losses.append(float(loss.detach()))
    return {"losses": losses, "first_input": first_input, "first_grad": first_grad,
            "params": {k: p.detach() for k, p in params.items()}, "buffers": buffers}
