"""Denormalised masked L1 loss (port of ``resdepth_tpu/train/loss.py``).

Predictions and targets are mapped back to metric heights (x * sigma +
per-sample mean), invalid pixels and zero-weight padding samples are
excluded, and the mean runs over the valid pixels: the masked MAE in
meters, the reference's one training and validation metric.

Under data parallelism the denominator is summed over the ranks and the
numerator stays each rank's own, so the sum of the ranks' gradients is the
gradient of the global masked mean.
"""

from __future__ import annotations

import torch

from resdepth_tpu_torch.parallel import mesh


def denormalized_masked_l1(pred, target, loss_mask, dsm_mean, dsm_std,
                           sample_weights=None, group=None):
    """Returns ``(loss, (num, den))``: ``num`` the masked absolute-error sum
    in meters and ``den`` the weighted valid-pixel count of this rank's
    batch, ``loss = num / max(den summed over group, 1)`` (``group`` None:
    this process's batch alone). Inputs are NHWC, (B, T, T, 1)."""
    pred = pred.float()
    target = target.float()
    mean = dsm_mean[:, None, None, None]
    pred_m = pred * dsm_std + mean
    target_m = target * dsm_std + mean

    weights = loss_mask.float()
    if sample_weights is not None:
        weights = weights * sample_weights[:, None, None, None]

    num = (torch.abs(pred_m - target_m) * weights).sum()
    den = weights.sum()
    den_global = mesh.all_reduce_(den.detach().clone(), group)
    return num / torch.clamp_min(den_global, 1.0), (num, den)
