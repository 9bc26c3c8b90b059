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

The string serving modes (``serving_precision``: ``mixed``, ``fast32``,
``act2pass``, ``balanced``, ``balanced16``) run the eval forward at the JAX
package's per-layer precisions, each an explicit number of bf16 product
passes with float32 sums (``Precision``, ``ops/passes.py``): the 3x3 convs
on kernel K3 (``ops.conv.conv3x3_bias_act``), the upconvs with their skip
adds on ``ops.upconv.upconv2x2_skip``. Training runs at the same
precisions (the training precisions of ``train.py``), its gradients at each
conv's passes (``ops.passes.same_conv``, ``ops.passes.upconv2x2``). See
``apply_unet``.

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
import enum
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from resdepth_tpu_torch.ops import epilogue, passes as pass_ops, upconv
from resdepth_tpu_torch.ops.conv import _activate, conv3x3_bias_act
from resdepth_tpu_torch.parallel import mesh

ACTIVATIONS = ("relu", "lrelu", "prelu")
UP_MODES = ("transpose", "bilinear")

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
LRELU_SLOPE = 0.01
PRELU_INIT = 0.25


class Precision(enum.Enum):
    """The port's names for the JAX package's conv precisions
    (``jax.lax.Precision``) on float32 operands: ``DEFAULT`` is one bf16
    product pass, ``HIGH`` three (the hi/lo split of both operands),
    ``HIGHEST`` exact float32 (IEEE, TF32 off). The pair ``(HIGH,
    DEFAULT)`` splits the activation and rounds the weights once: two
    passes. bfloat16 operands take one native pass at any precision."""
    DEFAULT = "default"
    HIGH = "high"
    HIGHEST = "highest"


_PASSES = {Precision.DEFAULT: 1, (Precision.HIGH, Precision.DEFAULT): 2,
           Precision.HIGH: 3}


def precision_passes(precision) -> int | None:
    """bf16 passes of ``precision`` on float32 operands; None for exact
    float32 (``HIGHEST``)."""
    if precision == Precision.HIGHEST:
        return None
    if precision not in _PASSES:
        raise ValueError(f"unknown precision {precision!r}: one of "
                         f"{list(Precision)} or (HIGH, DEFAULT)")
    return _PASSES[precision]


@dataclasses.dataclass(frozen=True)
class ServingMode:
    """How ``apply_unet`` runs one string serving mode (port of the JAX
    ``ServingMode``).

    ``mixed``: bf16 activation trunk (requires f32 input ``x``).
    ``precision`` / ``layer_precisions``: per-conv precision (``Precision``).
    ``hifi_endpoints``: on the bf16 trunk, the first conv reads the raw f32
    input and the composed top runs on f32-upcast activations with f32
    weights.
    """
    mixed: bool = False
    precision: object = None
    layer_precisions: dict | None = None
    hifi_endpoints: bool = False

    def apply_kwargs(self) -> dict:
        """Keyword arguments for ``apply_unet``."""
        return dict(mixed_precision=self.mixed, precision=self.precision,
                    layer_precisions=self.layer_precisions,
                    hifi_endpoints=self.hifi_endpoints)


def serving_precision(mode: str) -> ServingMode:
    """The string ``compute_dtype`` serving modes, as the JAX package
    defines them in TPU MXU passes (``resdepth_tpu/models/unet.py``):

    - ``mixed``: bf16 trunk; the composed top's two convs take the bf16
      activations and bf16-rounded weights with float32 sums (1 pass).
    - ``fast32``: f32 storage, 1 pass everywhere.
    - ``act2pass``: f32 storage, 2 passes everywhere (activation split).
    - ``balanced``: f32 storage, 1 pass except ``encoder0`` and ``last`` at
      3 passes.
    - ``balanced16``: bf16 trunk with ``hifi_endpoints``; ``encoder0`` and
      the top at 3 passes.
    """
    H, D = Precision.HIGH, Precision.DEFAULT
    table = {
        "mixed": ServingMode(mixed=True),
        "fast32": ServingMode(precision=D),
        "act2pass": ServingMode(precision=(H, D)),
        "balanced": ServingMode(precision=D,
                                layer_precisions={"encoder0": H, "last": H}),
        "balanced16": ServingMode(mixed=True, hifi_endpoints=True,
                                  layer_precisions={"encoder0": H, "last": H}),
    }
    return table[mode]


SERVING_PRECISION_MODES = ("mixed", "fast32", "act2pass", "balanced",
                           "balanced16")


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
    ``UNet.run`` evaluates it at the policy's precision
    (``_composed_top_at``).
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
            remat: bool = False, serving: ServingMode | None = None, group=None):
        """The forward pass -> ``(y, bn_state)``, whatever the module's mode.

        ``train`` selects batch statistics for BatchNorm (``batch_norm_train``,
        weighted by ``sample_weights`` (N,) when given); ``bn_state`` then maps
        each BatchNorm buffer name (``encoder.0.0.1.running_mean``, ...) to
        its new value, and is empty otherwise. ``remat`` (training only)
        recomputes each conv(+BN+act) block in the backward pass
        (``torch.utils.checkpoint``) instead of storing its activations.
        ``serving`` is the precision policy, a serving mode's or a training
        policy's (``_AtPrecision``); None is the module's own arithmetic,
        the ``HIGHEST`` policy: IEEE float32 on float32 operands, the
        native pass on bfloat16 ones. ``group`` (training) takes
        BatchNorm's batch statistics over every rank of a
        ``torch.distributed`` group (``batch_norm_train``)."""
        if serving is None:
            serving = ServingMode(precision=Precision.HIGHEST)
        ops = _AtPrecision(serving, train, sample_weights, remat, group)
        skips = []
        out = ops.input(x)
        for i, level in enumerate(self.encoder):
            skip, out = ops.encoder(f"encoder.{i}.0", level, out)
            skips.append(skip)
        out = ops.block("bottleneck", self.bottleneck, out)
        for i, level in enumerate(self.decoder):
            if i < self.config.depth - 1:
                out = ops.decoder(i, level[0], skips[-1 - i], out)
                out = ops.block(f"decoder.{i}.1", level[1], out)
            else:   # deepest level: no conv after the skip
                out = ops.decoder(i, level, skips[0], out)
        if self.top_composed is not None:
            out = ops.top(self.top_composed, skips[0], out, self.last_layer)
        else:
            out = ops.last(self.last_layer, out)
        out = ops.result(out, x)
        if self.config.outer_skip:
            bn = self.layer_outer_skip[0] if self.config.outer_skip_BN else None
            out = out + ops.outer_skip(bn, x[:, 0:1])
        return out, ops.bn_state


def batch_norm_train(bn: nn.BatchNorm2d, x, sample_weights=None, group=None):
    """Training-mode BatchNorm with the JAX package's moments
    (``resdepth_tpu/models/unet.py::_batch_norm``) -> ``(y, mean, var)``.

    The batch statistics over (N, H, W) are ``E[x]`` and ``E[x^2] - E[x]^2``
    clamped at 0, in float32. With ``sample_weights`` (N,) each sample's
    pixels weigh its weight, normalised by the weighted pixel count first,
    so zero-weight samples add nothing. ``y`` uses the biased variance; the
    returned running statistics (``bn``'s buffers moved by momentum 0.1,
    not written) take the unbiased one. Gradients flow through the batch
    statistics, not into the running ones.

    ``group`` (``parallel.mesh``) takes the statistics over every rank's
    batch, as the JAX ``axis_name``: the weighted pixel count is summed over
    the ranks, then the weighted moments; without weights the ranks' moments
    are averaged (the JAX ``pmean``). The moments travel as one packed
    all-reduce a layer, whose backward sums their gradients over the ranks
    (``mesh.all_reduce_sum``)."""
    x32 = x.float()
    n, _, h, w = x32.shape
    dims = (0, 2, 3)
    ranks = mesh.size(group)
    if sample_weights is None:
        mean = x32.mean(dim=dims)
        mean_sq = x32.square().mean(dim=dims)
        count = torch.tensor(float(n * h * w * ranks), device=x.device)
    else:
        weights = sample_weights.to(device=x.device, dtype=torch.float32)
        count = mesh.all_reduce_(weights.sum() * (h * w), group)
        count = torch.clamp_min(count, 1.0)
        wn = (weights / count).view(-1, 1, 1, 1)
        mean = (x32 * wn).sum(dim=dims)
        mean_sq = (x32.square() * wn).sum(dim=dims)
    if group is not None:
        mean, mean_sq = mesh.all_reduce_sum(torch.cat([mean, mean_sq]), group).chunk(2)
        if sample_weights is None:
            mean, mean_sq = mean / ranks, mean_sq / ranks
    var = torch.clamp_min(mean_sq - mean.square(), 0.0)
    with torch.no_grad():
        unbiased = var * (count / torch.clamp_min(count - 1, 1.0))
        new_mean = (1 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * mean
        new_var = (1 - BN_MOMENTUM) * bn.running_var + BN_MOMENTUM * unbiased
    inv = torch.rsqrt(var + BN_EPS) * bn.weight
    y = ((x32 - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
         + bn.bias.view(1, -1, 1, 1))
    return y.to(x.dtype), new_mean, new_var


def commit_bn_state(model: nn.Module, bn_state: dict) -> None:
    """Write new BatchNorm running statistics (``UNet.run``'s ``bn_state``)
    into ``model``'s buffers, in place."""
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for name, value in bn_state.items():
            buffers[name].copy_(value)


def apply_unet(model: UNet, x: torch.Tensor, *, train: bool = False,
               sample_weights=None, remat: bool = False,
               mixed_precision: bool = False, precision=None,
               layer_precisions: dict | None = None,
               hifi_endpoints: bool = False, group=None):
    """``apply_unet``'s contract: NHWC in, (N, H, W, 1) out.

    ``train=False`` returns the output. ``train=True`` uses batch statistics
    (weighted by ``sample_weights``, over every rank of ``group`` when given,
    as the JAX ``axis_name``) and returns ``(y, bn_state)``, the new
    running statistics by buffer name, leaving the module's buffers as they
    are (``commit_bn_state`` writes them), as the JAX function returns its
    new state.

    ``mixed_precision``, ``precision``, ``layer_precisions`` and
    ``hifi_endpoints`` are the JAX function's (``ServingMode.apply_kwargs``),
    in eval and in training (``_AtPrecision``); with none of them set the
    forward is the module's own arithmetic (``UNet.run``'s ``HIGHEST``
    policy). An ``x`` in another dtype than the parameters (bfloat16
    compute on float32 weights) runs too: each conv casts its weights to
    ``x.dtype``, as the JAX graph does."""
    serving = None
    if mixed_precision or precision is not None or layer_precisions:
        serving = ServingMode(mixed_precision, precision, layer_precisions,
                              hifi_endpoints)
    y, bn_state = model.run(x.permute(0, 3, 1, 2), train=train,
                            sample_weights=sample_weights, remat=remat,
                            serving=serving, group=group)
    y = y.permute(0, 2, 3, 1)
    return (y, bn_state) if train else y


# ------------------------------ at a precision ---------------------------- #
# The module's parameters as they are (float32 for a serving mode and in
# training: each conv casts its weights, as the JAX graph casts its kernels
# per conv).

class _AtPrecision:
    """``UNet.run``'s layers at a precision policy: the forward of the JAX
    ``apply_unet`` with ``mixed_precision``, ``precision``,
    ``layer_precisions`` and ``hifi_endpoints``, in eval with BatchNorm on
    its running statistics, or in training on the batch's (their new
    running values collected in ``bn_state``). The module's own arithmetic
    is the ``HIGHEST`` policy: IEEE float32 on float32 operands, the native
    pass on bfloat16 ones.

    Each conv takes the precision of its layer (``layer_precisions[name]``,
    else ``precision``), by the JAX names: ``encoder{i}``, ``bottleneck``,
    ``up{i}``, ``decoder{i}`` and ``last`` (both convs of a composed top).
    A layer left without one is HIGH on float32 operands, as the JAX
    package reads None. ``mixed`` (float32 input only) runs a bf16 trunk,
    cast where the JAX graph casts: the input, every encoder output; the
    top gives float32 (K3 reads the bf16 activations as they lie, at their
    float32 values) and the outer skip adds the raw f32 channel 0.
    ``hifi_endpoints`` (with ``mixed``) feeds ``encoder0`` the raw f32
    input and runs the composed top on the activations' float32 values
    with f32 weights. The bias map of a composed top is exact float32
    (HIGHEST), as in JAX. A bf16 conv adds its bias after its sums are rounded to bf16,
    and the bilinear 2x resize works one axis at a time (``_resize2x``),
    the JAX orders.

    In eval, the bf16 trunk's elementwise work after each conv (bias,
    activation, the cast of a float32 encoder0 output, the 2x2 max-pool,
    the upsampling's bias and the additive skip) is one pass of
    ``ops.epilogue``, bitwise the separate ops (``_block_at``,
    ``_upconv_bf16``). On float32 storage a transposed upconv with a pass
    count, its bias and the additive skip are one launch of
    ``ops.upconv`` (its plain version on the CPU: the same ops), where no
    operand needs a gradient; float32 storage keeps its other ops.

    In training (``_block_train_at``) BatchNorm takes the batch's
    statistics in float32, cast back to the conv's dtype, and the activation
    is a separate op; an f32 conv with a pass count runs, and takes its
    gradients, at those passes (``ops.passes.same_conv``, ``upconv2x2``)."""

    def __init__(self, serving: ServingMode, train: bool, sample_weights, remat: bool,
                 group):
        self.mode = serving
        self.train, self.sample_weights, self.remat = train, sample_weights, remat
        self.group = group
        self.bn_state: dict = {}

    def _precision(self, name: str):
        layers = self.mode.layer_precisions or {}
        precision = layers.get(name, self.mode.precision)
        return Precision.HIGH if precision is None else precision

    def input(self, x):
        """The first conv's input."""
        if self.mode.mixed:
            if x.dtype != torch.float32:
                raise ValueError(f"mixed_precision needs a float32 input, got {x.dtype}")
            # hifi_endpoints: the first conv reads the raw f32 input
            x = x if self.mode.hifi_endpoints else x.to(torch.bfloat16)
        if x.dtype == torch.bfloat16 and not self.train:
            # the epilogue reads NHWC memory, and cuDNN writes its output in
            # the layout of its input: lay out a rotated view (test-time
            # augmentation) so; no value changes. A one-channel batch in
            # NCHW memory passes for channels-last contiguous as it lies, so
            # its strides are named NHWC (the same memory) for cuDNN to see
            x = x.contiguous(memory_format=torch.channels_last)
            if x.shape[1] == 1:
                n, _, h, w = x.shape
                x = x.as_strided(x.shape, (h * w, 1, w, 1))
        return x

    def _block_precision(self, prefix):
        # "encoder.0.0" -> encoder0, "decoder.1.1" -> decoder1, "bottleneck"
        return self._precision("".join(prefix.split(".")[:2]))

    def encoder(self, prefix, level, x):
        """An encoder level -> ``(skip, pooled)``: the block, the trunk's
        storage of its output, the level's 2x2 max-pool."""
        if not self.train:
            return self._eval_block(prefix, level[0], x, level[1])
        skip = self.block(prefix, level[0], x)
        skip = skip.to(torch.bfloat16) if self.mode.mixed else skip
        return skip, level[1](skip)

    def decoder(self, i, module, skip, x):
        """A decoder level's additive skip: ``skip + up(x)``. In eval, one
        pass of ``ops.epilogue`` after the bf16 trunk's upsampling, and one
        launch of ``ops.upconv`` for a float32 transposed conv with a pass
        count that needs no gradient."""
        if not self.train and x.dtype == torch.bfloat16:
            return epilogue.skip_add_epilogue(*_upconv_bf16(module, x), skip)
        precision = self._precision(f"up{i}")
        passes = precision_passes(precision)
        if (not self.train and passes is not None and x.dtype == torch.float32
                and isinstance(module, nn.ConvTranspose2d)
                and not _needs_grad(x, skip, module.weight, module.bias)):
            y = upconv.upconv2x2_skip(x.permute(0, 2, 3, 1), module.weight, module.bias,
                                      skip.permute(0, 2, 3, 1), passes)
            return y.permute(0, 3, 1, 2)
        return skip + _upconv_at(module, x, precision)

    def block(self, prefix, seq, x):
        """A conv block; in training under ``torch.utils.checkpoint`` with
        ``remat``, its BN statistics into ``bn_state``."""
        if not self.train:
            return self._eval_block(prefix, seq, x)[0]
        args = (seq, x, self.sample_weights, self.group, self._block_precision(prefix))
        if self.remat:
            out, mean, var = torch.utils.checkpoint.checkpoint(
                _block_train_at, *args, use_reentrant=False)
        else:
            out, mean, var = _block_train_at(*args)
        if mean is not None:
            self.bn_state[f"{prefix}.1.running_mean"] = mean
            self.bn_state[f"{prefix}.1.running_var"] = var
        return out

    def _eval_block(self, prefix, seq, x, pool=None):
        """An eval conv block -> ``(out, pool(out) or None)``. On the bf16
        trunk (a bf16 conv, or ``mixed``'s storage of an f32 encoder0) the
        bias, activation, cast and pool are one pass of the epilogue."""
        y, bias, act_fn, slope = _block_at(seq, x, self._block_precision(prefix))
        if y.dtype == torch.bfloat16 or (pool is not None and self.mode.mixed):
            return epilogue.trunk_epilogue(y, bias, slope, act_fn=act_fn,
                                           pool=pool is not None)
        return y, None if pool is None else pool(y)

    def top(self, top, skip, d1, last):
        return _composed_top_at(top, last, skip, d1, self.mode.mixed,
                                self._precision("last"), self.mode.hifi_endpoints)

    def last(self, last, x):
        conv = _conv3x3_train if self.train else _conv3x3
        return conv(x.float() if self.mode.mixed else x, last.weight, last.bias,
                    self._precision("last"))

    def result(self, y, x):
        """The network's output before the outer skip."""
        return y.to(torch.float32 if self.mode.mixed else x.dtype)

    def outer_skip(self, bn, x0):
        if bn is None:
            return x0
        if not self.train:
            return _batch_norm_f32(bn, x0)
        x0, mean, var = batch_norm_train(bn, x0, self.sample_weights, self.group)
        self.bn_state["layer_outer_skip.0.running_mean"] = mean
        self.bn_state["layer_outer_skip.0.running_var"] = var
        return x0


def _needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on ``tensors`` (None skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _act_spec(module: nn.Module, channels: int):
    """An activation module as K3's ``act_fn`` and per-channel slopes."""
    if isinstance(module, nn.ReLU):
        return "relu", None
    if isinstance(module, nn.LeakyReLU):
        return "lrelu", None
    return "prelu", module.weight.expand(channels)


def _activate_nchw(y, act_fn, slope):
    """``_activate`` on NCHW ``y`` with (C,) slopes."""
    return _activate(y, act_fn, None if slope is None else slope.view(-1, 1, 1))


def _batch_norm_f32(bn: nn.BatchNorm2d, x):
    """Eval BatchNorm on ``x`` in float32 (its statistics and affine too),
    cast back to ``x.dtype``."""
    stats = (t.float() for t in (bn.running_mean, bn.running_var, bn.weight, bn.bias))
    return F.batch_norm(x.float(), *stats, False, 0.0, BN_EPS).to(x.dtype)


def _add_bias(y, bias):
    """``y + bias`` per channel in ``y``'s dtype (after the conv rounded its
    sums to it, as the JAX ``_conv`` adds its bias)."""
    return y if bias is None else y + bias.to(y.dtype).view(-1, 1, 1)


def _conv3x3_bf16(x, weight):
    """The same-padded 3x3 conv of bf16 NCHW ``x`` on cuDNN, its sums
    rounded to bf16, before any bias."""
    return F.conv2d(x, weight.to(x.dtype), None, padding=1)


def _conv3x3(x, weight, bias, precision, act_fn="none", slope=None):
    """Same-padded 3x3 conv + bias + activation on NCHW ``x`` with an OIHW
    ``weight``, as the JAX ``_conv`` at ``precision``. bf16 ``x``: cuDNN in
    bf16, a bf16 result, then the bf16 bias (the JAX order); f32 ``x``:
    kernel K3 at the precision's passes, or IEEE float32 where it has none
    (``precision_passes``)."""
    if x.dtype == torch.bfloat16:
        y = _add_bias(_conv3x3_bf16(x, weight), bias)
        return _activate_nchw(y, act_fn, slope)
    return _conv3x3_f32(x, weight, bias, precision, act_fn, slope)


def _conv3x3_f32(x, weight, bias, precision, act_fn="none", slope=None):
    """``_conv3x3`` on the float32 value of NCHW ``x``, float32 or bf16
    (exact in float32), with a float32 result: kernel K3 at the precision's
    passes, which takes a bf16 ``x`` as it lies (``ops/conv.py``), or IEEE
    float32 where it has none."""
    passes = precision_passes(precision)
    if passes is None:
        return _activate_nchw(F.conv2d(x.float(), weight, bias, padding=1), act_fn, slope)
    y = conv3x3_bias_act(x.permute(0, 2, 3, 1), weight.permute(2, 3, 1, 0), bias,
                         slope, act_fn=act_fn, passes=passes)
    return y.permute(0, 3, 1, 2)


def _block_at(seq: nn.Sequential, x, precision):
    """An eval conv (+BN with running statistics) + activation at
    ``precision`` -> ``(y, bias, act_fn, slope)``, what is left of it for
    ``ops.epilogue.trunk_epilogue``. bf16 ``x``: the raw cuDNN conv (+BN in
    float32, cast back), its bias and activation left; f32 ``x``: the whole
    block (K3 applies bias and activation), nothing left."""
    conv = seq[0]
    act_fn, slope = _act_spec(seq[-1], conv.out_channels)
    bn = seq[1] if isinstance(seq[1], nn.BatchNorm2d) else None
    if x.dtype == torch.bfloat16:
        y = _conv3x3_bf16(x, conv.weight)
        if bn is None:
            return y, conv.bias, act_fn, slope
        return _batch_norm_f32(bn, _add_bias(y, conv.bias)), None, act_fn, slope
    if bn is None:
        y = _conv3x3(x, conv.weight, conv.bias, precision, act_fn, slope)
    else:
        y = _activate_nchw(_batch_norm_f32(bn, _conv3x3(x, conv.weight, conv.bias, precision)),
                           act_fn, slope)
    return y, None, "none", None


def _conv3x3_train(x, weight, bias, precision):
    """``_conv3x3`` without an activation, with gradients: an f32 conv
    with a pass count through ``ops.passes.same_conv`` (forward and dx on
    K3, dw and db at its passes), any other through autograd (the bf16
    trunk's convs on cuDNN, IEEE float32)."""
    passes = None if x.dtype == torch.bfloat16 else precision_passes(precision)
    if passes is None:
        return _conv3x3(x, weight, bias, precision)
    return pass_ops.same_conv(x, weight, bias, passes)


def _block_train_at(seq: nn.Sequential, x, sample_weights, group, precision):
    """conv at ``precision`` (+BN with batch statistics) + activation ->
    ``(out, mean, var)``, the BN's new running statistics (None without
    BN). The activation is the module's own (PReLU's slopes cast to the
    activation's dtype, as JAX casts them)."""
    conv, act = seq[0], seq[-1]
    out = _conv3x3_train(x, conv.weight, conv.bias, precision)
    mean = var = None
    if isinstance(seq[1], nn.BatchNorm2d):
        out, mean, var = batch_norm_train(seq[1], out, sample_weights, group)
    if isinstance(act, nn.PReLU):
        return _activate_nchw(out, *_act_spec(act, conv.out_channels)), mean, var
    return act(out), mean, var


def _resize2x(x):
    """The half-pixel bilinear 2x resize as ``jax.image.resize`` computes
    it: one axis at a time, rows then columns, each in float32 and rounded
    to ``x.dtype``."""
    h, w = x.shape[2:]
    for size in ((2 * h, w), (2 * h, 2 * w)):
        x = F.interpolate(x.float(), size=size, mode="bilinear",
                          align_corners=False).to(x.dtype)
    return x


def _upconv_bf16(module: nn.Module, x):
    """The 2x upsampling of bf16 ``x`` in bf16 before its bias -> ``(u,
    bias)``: the 2x2 stride-2 transposed conv, or the half-pixel bilinear
    resize (``_resize2x``) and the 1x1 conv."""
    transpose = isinstance(module, nn.ConvTranspose2d)
    conv = module if transpose else module[1]
    if transpose:
        return pass_ops.conv_transpose2d(x, conv.weight.to(x.dtype)), conv.bias
    return pass_ops.conv2d(_resize2x(x), conv.weight.to(x.dtype)), conv.bias


def _upconv_at(module: nn.Module, x, precision):
    """The 2x upsampling of ``x`` at ``precision`` (``ops.passes``, with
    gradients at its passes; bf16 ``x`` runs in bf16, its bias added after
    the conv's rounding): the 2x2 stride-2 transposed conv, or the
    half-pixel bilinear resize (``_resize2x``) and the 1x1 conv."""
    if x.dtype == torch.bfloat16:
        return _add_bias(*_upconv_bf16(module, x))
    transpose = isinstance(module, nn.ConvTranspose2d)
    conv = module if transpose else module[1]
    up = x if transpose else _resize2x(x)
    run = pass_ops.conv_transpose2d if transpose else pass_ops.conv2d
    passes = precision_passes(precision)
    if passes is None:
        return run(up, conv.weight, conv.bias)
    with_grads = pass_ops.upconv2x2 if transpose else pass_ops.same_conv
    return with_grads(up, conv.weight, conv.bias, passes)


def _composed_top_at(top: ComposedTop, last: nn.Conv2d, skip, d1, mixed: bool,
                     precision, hifi_endpoints: bool):
    """``ComposedTop`` at ``precision``: the three branches of the JAX
    ``_composed_top``."""
    w_last, w_ck = last.weight, top.ck
    conv = _conv3x3
    if mixed:
        # f32 results from the bf16 trunk, on the activations' float32
        # values, which split exactly (lo = 0): K3 takes them as they lie,
        # IEEE float32 upcast (``_conv3x3_f32``). With hifi_endpoints the
        # weights stay f32; without, they are bf16-rounded and every product
        # is exact in one pass.
        conv = _conv3x3_f32
        if not hifi_endpoints:
            w_last = w_last.to(torch.bfloat16).float()
            w_ck = w_ck.to(torch.bfloat16).float()
            if precision != Precision.HIGHEST:
                precision = Precision.DEFAULT
    ys = conv(skip, w_last, None, precision)
    yd = conv(d1, w_ck, None, precision)
    ones = torch.ones((1, 1) + skip.shape[2:], dtype=torch.float32,
                      device=skip.device)
    bias_map = F.conv2d(ones, top.s_map, None, padding=1)     # HIGHEST
    y = ys + F.pixel_shuffle(yd, 2) + bias_map.to(ys.dtype)
    if last.bias is not None:
        y = y + last.bias.to(ys.dtype).view(1, -1, 1, 1)
    return y


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


# ------------------------------- accounting ------------------------------- #

def param_count(model: UNet) -> int:
    """Trainable parameters of ``model`` (the JAX ``param_count`` of its
    params tree: the same leaves)."""
    return int(sum(p.numel() for p in model.parameters()))


def analytic_flops(config: UNetConfig, tile_size: int, *,
                   composed_top: bool = False) -> int:
    """Conv FLOPs of one forward on a ``tile_size`` tile, multiply-adds as
    2 (port of ``resdepth_tpu/models/unet.py::analytic_flops``): the
    encoder's 3x3 convs, the bottleneck, ``depth`` upsamplings (one tap an
    output pixel, transposed or bilinear + 1x1), the 3x3 conv after each
    non-top skip and the last conv to one channel. With ``composed_top``
    (``fold_serving``'s graph, transpose mode only: the fold is a no-op for
    bilinear) the top upconv is folded into the last conv: the skip conv at
    full resolution and a 4-phase conv at half. A train step is about 3x."""
    widths = config.filter_depths
    t = tile_size
    flops = 0
    in_ch = config.n_input_channels
    for i, w in enumerate(widths):
        r = t >> i
        flops += 2 * 9 * r * r * in_ch * w
        in_ch = w
    r = t >> config.depth
    flops += 2 * 9 * r * r * widths[-1] * widths[-1]
    composed = composed_top and config.up_mode == "transpose"
    widths_up = tuple(reversed(widths))
    for i in range(config.depth):
        r_out = t >> (config.depth - 1 - i)
        top = i == config.depth - 1
        if top and composed:
            break
        flops += 2 * r_out * r_out * widths_up[i] * widths_up[i]
        if not top:
            flops += 2 * 9 * r_out * r_out * widths_up[i] * widths_up[i + 1]
    flops += 2 * 9 * t * t * config.start_kernel * 1
    if composed:
        flops += 2 * 9 * (t // 2) * (t // 2) * config.start_kernel * 4
    return flops


def describe_unet(model: UNet, tile_size: int | None = None) -> str:
    """Layer-by-layer summary of ``model``'s parameters, the text of the
    JAX ``describe_unet`` (reference: ``lib/utils.py:711-729``, via
    torchsummary): one row a block of the JAX params tree, its kernel's
    HWIO shape where the block is a bare conv, and its parameter count."""
    from resdepth_tpu_torch.models.weights import jax_params_from_state_dict

    config = model.config
    params, _ = jax_params_from_state_dict(model.state_dict(), config)
    lines = [f"UNet architecture ({config.depth} levels, "
             f"{config.n_input_channels} input channels)", ""]
    lines.append(f"{'layer':<28}{'kernel':<22}{'params':>12}")
    lines.append("-" * 62)
    total = 0

    def leaves(tree):
        if isinstance(tree, dict):
            return [leaf for value in tree.values() for leaf in leaves(value)]
        if isinstance(tree, (list, tuple)):
            return [leaf for value in tree for leaf in leaves(value)]
        return [tree]

    def row(name, layer):
        nonlocal total
        count = int(sum(np.prod(leaf.shape) for leaf in leaves(layer)))
        total += count
        kernel = tuple(layer["kernel"].shape) if "kernel" in layer else "-"
        lines.append(f"{name:<28}{str(kernel):<22}{count:>12,}")

    for i, block in enumerate(params["encoder"]):
        row(f"encoder.{i}.conv(+bn)", block)
        lines.append(f"{'encoder.' + str(i) + '.maxpool2x2':<28}{'-':<22}{0:>12,}")
    row("bottleneck.conv(+bn)", params["bottleneck"])
    for i, block in enumerate(params["decoder"]):
        label = f"decoder.{i}.up" + ("" if "conv" not in block else "+conv(+bn)")
        row(label, block)
    row("last.conv3x3", params["last"])
    if "outer_skip_bn" in params:
        row("outer_skip.bn", params["outer_skip_bn"])
    elif config.outer_skip:
        lines.append(f"{'outer_skip.add':<28}{'-':<22}{0:>12,}")

    lines.append("-" * 62)
    lines.append(f"{'total':<50}{total:>12,}")
    if tile_size:
        widths = config.filter_depths
        act_mb = sum((tile_size // 2 ** i) ** 2 * w * 4 / 2 ** 20
                     for i, w in enumerate(widths))
        lines.append(f"approx. activation footprint per sample @{tile_size}px "
                     f"(f32 encoder): {act_mb:.1f} MiB")
    return "\n".join(lines)
