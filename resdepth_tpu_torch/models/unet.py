"""Residual-refinement UNet as a PyTorch module, eval and train mode.

Port of ``resdepth_tpu/models/unet.py``. The module
keeps the reference network's topology and ``state_dict`` key layout
(``tests/torch_unet.py`` is the same network written as a test oracle), so
a reference ``.pth`` checkpoint loads verbatim:

  * one conv per encoder level, additive skips, the deepest decoder level
    has no conv after the add,
  * conv bias only where no BatchNorm follows,
  * widths ``start_kernel * 2^i`` capped at ``max_filter_depth``,
  * an optional outer residual skip adding input channel 0 to the output,
    optionally through a BatchNorm.

Layouts: NCHW inside the module (PyTorch's and cuDNN's habit);
``apply_unet`` keeps the JAX package's NHWC contract at the boundary.

The serving rewrites (``fold_batchnorm``, ``fold_top_decoder``,
``fold_serving``) return new modules and leave their input untouched.

Training mode keeps the JAX package's BatchNorm rather than torch's: the
batch moments are ``E[x]`` and ``E[x^2] - E[x]^2`` (clamped at 0), taken
over (N, H, W) with optional per-sample weights, so that zero-weight padding
samples stay out of the statistics (``BatchNorm2d`` has no sample weights).
``apply_unet(train=True)`` returns the new running statistics instead of
writing them, as the JAX function does; ``UNet.forward`` in training mode
writes them, as torch modules do.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

ACTIVATIONS = ("relu", "lrelu", "prelu")
UP_MODES = ("transpose", "bilinear")

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
LRELU_SLOPE = 0.01
PRELU_INIT = 0.25


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    n_input_channels: int = 1
    start_kernel: int = 64
    max_filter_depth: int = 512
    depth: int = 5
    act_fn_encoder: str = "relu"
    act_fn_decoder: str = "relu"
    act_fn_bottleneck: str = "relu"
    up_mode: str = "transpose"
    do_BN: bool = True
    bias_conv_layer: bool = False
    outer_skip: bool = True
    outer_skip_BN: bool = False

    def __post_init__(self):
        for act in (self.act_fn_encoder, self.act_fn_decoder, self.act_fn_bottleneck):
            if act not in ACTIVATIONS:
                raise ValueError(f"'{act}' is not a valid activation. Choose among {ACTIVATIONS}.")
        if self.up_mode not in UP_MODES:
            raise ValueError(f"'{self.up_mode}' is not a valid up_mode. Choose among {UP_MODES}.")

    @property
    def filter_depths(self) -> tuple[int, ...]:
        return tuple(min(self.start_kernel * (2 ** i), self.max_filter_depth)
                     for i in range(self.depth))


def unet_config_from_settings(settings: dict) -> UNetConfig:
    """Build a UNetConfig from the cfg.model.settings dict (model_config.json)."""
    fields = {f.name for f in dataclasses.fields(UNetConfig)}
    return UNetConfig(**{k: v for k, v in settings.items() if k in fields})


def flagship_config(input_channels: str = "geom-stereo") -> UNetConfig:
    """The paper's headline architecture: depth-5 UNet, start 64, cap 512."""
    from resdepth_tpu_torch.config.schema import count_input_channels
    return UNetConfig(n_input_channels=count_input_channels(input_channels))


# ------------------------------- layers ----------------------------------- #

def _activation(act_fn: str) -> nn.Module:
    if act_fn == "relu":
        return nn.ReLU()
    if act_fn == "lrelu":
        return nn.LeakyReLU(LRELU_SLOPE)
    return nn.PReLU(1, init=PRELU_INIT)


def _conv_block(cin: int, cout: int, act_fn: str, do_bn: bool) -> nn.Sequential:
    """conv3x3 (+BN) + activation; keys ``.0`` conv, ``.1`` BN, last = act."""
    layers = [nn.Conv2d(cin, cout, 3, padding=1, bias=not do_bn)]
    if do_bn:
        layers.append(nn.BatchNorm2d(cout, eps=BN_EPS))
    layers.append(_activation(act_fn))
    return nn.Sequential(*layers)


def _upconv(channels: int, up_mode: str) -> nn.Module:
    if up_mode == "transpose":
        return nn.ConvTranspose2d(channels, channels, 2, stride=2)
    # bilinear: half-pixel-centred 2x resize + conv1x1 (with bias); the JAX
    # graph uses jax.image.resize(method="linear"), which agrees with
    # align_corners=False including the clamped borders.
    return nn.Sequential(nn.Upsample(scale_factor=2, mode="bilinear",
                                     align_corners=False),
                         nn.Conv2d(channels, channels, 1))


class ComposedTop(nn.Module):
    """Top pyramid level after ``fold_top_decoder``.

    ``last(skip0 + upconv(d1))`` evaluated as the final conv on the skip at
    full resolution, plus one 3x3 conv ``ck`` on the half-resolution ``d1``
    to the four pixel phases (channel ``2a + b`` for output row ``2i + a``,
    column ``2j + b``, which is ``F.pixel_shuffle``'s order), plus the map
    the upconv bias leaves through the final conv's zero padding.
    """

    def __init__(self, c_d1: int):
        super().__init__()
        self.ck = nn.Parameter(torch.empty(4, c_d1, 3, 3), requires_grad=False)
        self.register_buffer("s_map", torch.empty(1, 1, 3, 3))

    def _apply(self, fn, recurse=True):
        # The bias map is computed in f32 at every compute dtype, as in the
        # JAX graph: ``.to(dtype)`` moves s_map but keeps its f32 values.
        s_map = self.s_map
        super()._apply(fn, recurse)
        if self.s_map.dtype != torch.float32:
            self.s_map = s_map.to(self.s_map.device)
        return self

    def forward(self, skip, d1, last: nn.Conv2d):
        ys = F.conv2d(skip, last.weight, None, padding=1)
        yd = F.conv2d(d1, self.ck, None, padding=1)
        ones = torch.ones((1, 1) + skip.shape[2:], dtype=torch.float32,
                          device=skip.device)
        bias_map = F.conv2d(ones, self.s_map, None, padding=1)
        y = ys + F.pixel_shuffle(yd, 2) + bias_map.to(ys.dtype)
        if last.bias is not None:
            y = y + last.bias.view(1, -1, 1, 1)
        return y


class UNet(nn.Module):
    """ResDepth UNet with the reference ``state_dict`` keys, and the
    reference's parameter order (a ``.pth`` optimizer state indexes it).

    Construction allocates the parameters on ``device`` without
    initialising them and leaves the module in eval mode: load a state_dict
    (``models.weights``) or use ``init_unet``. ``composed_top=True`` builds
    the layout that ``fold_top_decoder`` produces (``top_composed`` in place
    of the top upconv; serving only).
    """

    def __init__(self, config: UNetConfig, device=None, *,
                 composed_top: bool = False):
        super().__init__()
        self.config = config
        widths = config.filter_depths
        rev = widths[::-1]
        with torch.device("meta"):
            self.encoder = nn.ModuleList()
            cin = config.n_input_channels
            for width in widths:
                self.encoder.append(nn.Sequential(
                    _conv_block(cin, width, config.act_fn_encoder, config.do_BN),
                    nn.MaxPool2d(2, 2)))
                cin = width
            self.bottleneck = _conv_block(widths[-1], widths[-1],
                                          config.act_fn_bottleneck, config.do_BN)
            self.decoder = nn.ModuleList()
            for i in range(config.depth - 1):
                self.decoder.append(nn.Sequential(
                    _upconv(rev[i], config.up_mode),
                    _conv_block(rev[i], rev[i + 1], config.act_fn_decoder,
                                config.do_BN)))
            self.top_composed = None
            if composed_top:
                self.top_composed = ComposedTop(rev[-1])
            else:
                self.decoder.append(_upconv(rev[-1], config.up_mode))
            self.last_layer = nn.Conv2d(config.start_kernel, 1, 3, padding=1,
                                        bias=config.bias_conv_layer)
            if config.outer_skip and config.outer_skip_BN:
                self.layer_outer_skip = nn.ModuleList([nn.BatchNorm2d(1, eps=BN_EPS)])
        self.to_empty(device=device if device is not None else "cpu")
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.last_layer.weight.device

    def forward(self, x):
        """``x``: (N, C, H, W) with the initial DSM as channel 0 -> (N, 1, H, W).

        In training mode BatchNorm takes the batch's statistics and writes
        the new running statistics into its buffers."""
        y, bn_state = self.run(x, train=self.training)
        if self.training:
            commit_bn_state(self, bn_state)
        return y

    def run(self, x, *, train: bool = False, sample_weights=None,
            remat: bool = False):
        """The forward pass -> ``(y, bn_state)``, whatever the module's mode.

        ``train`` selects batch statistics for BatchNorm (``batch_norm_train``,
        weighted by ``sample_weights`` (N,) when given); ``bn_state`` then maps
        each BatchNorm buffer name (``encoder.0.0.1.running_mean``, ...) to
        its new value, and is empty otherwise. ``remat`` (training only)
        recomputes each conv(+BN+act) block in the backward pass
        (``torch.utils.checkpoint``) instead of storing its activations."""
        depth = self.config.depth
        bn_state: dict = {}

        def block(prefix, seq, inp):
            if not train:
                return _conv_block_eval(seq, inp)
            if remat:
                out, mean, var = torch.utils.checkpoint.checkpoint(
                    _conv_block_train, seq, inp, sample_weights,
                    use_reentrant=False)
            else:
                out, mean, var = _conv_block_train(seq, inp, sample_weights)
            if mean is not None:
                bn_state[f"{prefix}.1.running_mean"] = mean
                bn_state[f"{prefix}.1.running_var"] = var
            return out

        skips = []
        out = x
        for i, level in enumerate(self.encoder):
            out = block(f"encoder.{i}.0", level[0], out)
            skips.append(out)
            out = level[1](out)
        out = block("bottleneck", self.bottleneck, out)
        for i, level in enumerate(self.decoder):
            if i < depth - 1:
                out = skips[-1 - i] + level[0](out)   # additive skip
                out = block(f"decoder.{i}.1", level[1], out)
            else:
                out = skips[0] + level(out)   # deepest level: no conv after
        if self.top_composed is not None:
            out = self.top_composed(skips[0], out, self.last_layer)
        else:
            out = self.last_layer(out)
        if self.config.outer_skip:
            x0 = x[:, 0:1]
            if self.config.outer_skip_BN:
                bn = self.layer_outer_skip[0]
                if train:
                    x0, mean, var = batch_norm_train(bn, x0, sample_weights)
                    bn_state["layer_outer_skip.0.running_mean"] = mean
                    bn_state["layer_outer_skip.0.running_var"] = var
                else:
                    x0 = _batch_norm_eval(bn, x0)
            out = out + x0
        return out, bn_state


def batch_norm_train(bn: nn.BatchNorm2d, x, sample_weights=None):
    """Training-mode BatchNorm with the JAX package's moments
    (``resdepth_tpu/models/unet.py::_batch_norm``) -> ``(y, mean, var)``.

    The batch statistics over (N, H, W) are ``E[x]`` and ``E[x^2] - E[x]^2``
    clamped at 0, in float32. With ``sample_weights`` (N,) each sample's
    pixels weigh its weight, normalised by the weighted pixel count first,
    so zero-weight samples add nothing. ``y`` uses the biased variance; the
    returned running statistics (``bn``'s buffers moved by momentum 0.1,
    not written) take the unbiased one. Gradients flow through the batch
    statistics, not into the running ones."""
    x32 = x.float()
    n, _, h, w = x32.shape
    dims = (0, 2, 3)
    if sample_weights is None:
        mean = x32.mean(dim=dims)
        mean_sq = x32.square().mean(dim=dims)
        count = torch.tensor(float(n * h * w), device=x.device)
    else:
        weights = sample_weights.to(device=x.device, dtype=torch.float32)
        count = torch.clamp_min(weights.sum() * (h * w), 1.0)
        wn = (weights / count).view(-1, 1, 1, 1)
        mean = (x32 * wn).sum(dim=dims)
        mean_sq = (x32.square() * wn).sum(dim=dims)
    var = torch.clamp_min(mean_sq - mean.square(), 0.0)
    with torch.no_grad():
        unbiased = var * (count / torch.clamp_min(count - 1, 1.0))
        new_mean = (1 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * mean
        new_var = (1 - BN_MOMENTUM) * bn.running_var + BN_MOMENTUM * unbiased
    inv = torch.rsqrt(var + BN_EPS) * bn.weight
    y = ((x32 - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
         + bn.bias.view(1, -1, 1, 1))
    return y.to(x.dtype), new_mean, new_var


def _batch_norm_eval(bn: nn.BatchNorm2d, x):
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        False, 0.0, BN_EPS)


def _conv_block_eval(seq: nn.Sequential, x):
    """conv (+BN with running statistics) + activation."""
    out = seq[0](x)
    if isinstance(seq[1], nn.BatchNorm2d):
        out = _batch_norm_eval(seq[1], out)
    return seq[-1](out)


def _conv_block_train(seq: nn.Sequential, x, sample_weights):
    """conv (+BN with batch statistics) + activation -> ``(out, mean, var)``,
    the BN's new running statistics (None without BN)."""
    out = seq[0](x)
    mean = var = None
    if isinstance(seq[1], nn.BatchNorm2d):
        out, mean, var = batch_norm_train(seq[1], out, sample_weights)
    return seq[-1](out), mean, var


def commit_bn_state(model: nn.Module, bn_state: dict) -> None:
    """Write new BatchNorm running statistics (``UNet.run``'s ``bn_state``)
    into ``model``'s buffers, in place."""
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for name, value in bn_state.items():
            buffers[name].copy_(value)


def apply_unet(model: UNet, x: torch.Tensor, *, train: bool = False,
               sample_weights=None, remat: bool = False):
    """``apply_unet``'s contract: NHWC in, (N, H, W, 1) out.

    ``train=False`` returns the output. ``train=True`` uses batch statistics
    (weighted by ``sample_weights``) and returns ``(y, bn_state)``, the new
    running statistics by buffer name, leaving the module's buffers as they
    are (``commit_bn_state`` writes them), as the JAX function returns its
    new state."""
    y, bn_state = model.run(x.permute(0, 3, 1, 2), train=train,
                            sample_weights=sample_weights, remat=remat)
    y = y.permute(0, 2, 3, 1)
    return (y, bn_state) if train else y


def init_unet(config: UNetConfig, generator: torch.Generator,
              device=None) -> UNet:
    """Torch-default initialisation drawn from ``generator``:
    U(+-1/sqrt(fan_in)) for every conv (the transposed conv's fan-in is its
    output side), identity BatchNorm, PReLU alpha 0.25 — as the JAX
    ``init_unet`` does. Draws on the CPU, then moves to ``device``."""
    model = UNet(config, "cpu")
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                if isinstance(module, nn.ConvTranspose2d):
                    fan_in = module.weight.shape[1] * 4
                else:
                    fan_in = module.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                module.weight.uniform_(-bound, bound, generator=generator)
                if module.bias is not None:
                    module.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
            elif isinstance(module, nn.PReLU):
                module.weight.fill_(PRELU_INIT)
    return model.to(device if device is not None else "cpu")


# --------------------------- serving rewrites ----------------------------- #

def _block_prefixes(config: UNetConfig) -> list[str]:
    return ([f"encoder.{i}.0" for i in range(config.depth)] + ["bottleneck"]
            + [f"decoder.{i}.1" for i in range(config.depth - 1)])


def fold_batchnorm(model: UNet) -> UNet:
    """Fold eval-mode BatchNorm into the preceding conv's weight and bias.

    ``y = (conv(x) - mean) * scale / sqrt(var + eps) + bias`` is an affine
    map per channel, so the folded network (``do_BN=False``) is exact up to
    rounding. ``outer_skip_BN`` normalises an input, not a conv output, and
    stays. Returns a new module; no-op without BatchNorm.
    """
    config = model.config
    if not config.do_BN:
        return model
    sd = model.state_dict()
    folded = {}
    with torch.no_grad():
        for p in _block_prefixes(config):
            factor = sd[f"{p}.1.weight"] * torch.rsqrt(sd[f"{p}.1.running_var"] + BN_EPS)
            folded[f"{p}.0.weight"] = sd[f"{p}.0.weight"] * factor.view(-1, 1, 1, 1)
            folded[f"{p}.0.bias"] = sd[f"{p}.1.bias"] - sd[f"{p}.1.running_mean"] * factor
            if f"{p}.2.weight" in sd:   # PReLU moves from index 2 to 1
                folded[f"{p}.1.weight"] = sd[f"{p}.2.weight"]
    prefixes = tuple(p + "." for p in _block_prefixes(config))
    folded.update({k: v for k, v in sd.items() if not k.startswith(prefixes)})
    out = UNet(dataclasses.replace(config, do_BN=False), model.device,
               composed_top=model.top_composed is not None)
    out.load_state_dict(folded)
    return out


def fold_top_decoder(model: UNet) -> UNet:
    """Compose the top upconv into the final conv (serving only).

    The top level is linear: the deepest decoder step has no conv or
    activation after its additive skip, so
    ``last(skip0 + upconv(d1)) = last(skip0) + (last . upconv)(d1) + bias``.
    ``last . upconv`` is one 3x3 conv on the half-resolution ``d1`` that
    writes the four pixel phases (the 2x2 stride-2 transposed conv writes
    each output pixel from exactly one tap); the upconv bias enters through
    the final conv's zero padding as the map of ``S[dy, dx] = sum_m
    K3[m, dy, dx] * b_up[m]`` convolved with ones. Same arithmetic as the
    JAX ``fold_top_decoder``, in numpy f32. Returns a new module; no-op for
    ``up_mode='bilinear'`` and when already composed.
    """
    config = model.config
    if config.up_mode != "transpose" or model.top_composed is not None:
        return model
    sd = model.state_dict()
    top = f"decoder.{config.depth - 1}"
    k_up = sd[f"{top}.weight"].detach().cpu().numpy()   # (c_d1, c_skip, 2, 2)
    b_up = sd[f"{top}.bias"].detach().cpu().numpy()     # (c_skip,)
    k3 = sd["last_layer.weight"].detach().cpu().numpy()[0]   # (c_skip, 3, 3)

    ck = np.zeros((4, k_up.shape[0], 3, 3), np.float32)
    for a in (0, 1):
        for b in (0, 1):
            for dy in (-1, 0, 1):
                ap, r = (a + dy) % 2, (a + dy) // 2
                for dx in (-1, 0, 1):
                    bp, s = (b + dx) % 2, (b + dx) // 2
                    # y(2i+a, 2j+b) += K3[m,dy,dx] * u(2i+a+dy, 2j+b+dx, m)
                    # u(2(i+r)+ap, 2(j+s)+bp, m) = K2[c,m,ap,bp] . d1(c, i+r, j+s)
                    ck[2 * a + b, :, r + 1, s + 1] += (
                        np.ascontiguousarray(k_up[:, :, ap, bp]) @ k3[:, dy + 1, dx + 1])
    s_map = np.einsum("myx,m->yx", k3, b_up)[None, None]

    composed = {k: v for k, v in sd.items() if not k.startswith(top + ".")}
    composed["top_composed.ck"] = torch.from_numpy(ck)
    composed["top_composed.s_map"] = torch.from_numpy(s_map.astype(np.float32))
    out = UNet(config, model.device, composed_top=True)
    out.load_state_dict(composed)
    return out


def fold_serving(model: UNet) -> UNet:
    """All exact serving-time rewrites: BN fold + top-decoder composition."""
    return fold_top_decoder(fold_batchnorm(model))
