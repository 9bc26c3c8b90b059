"""Which part bounds kernel K3's in-place variants (narrow, narrow_k,
wide_f32): each kernel timed on the card with parts of it cut out of a copy
of ``csrc/conv.cu``.

    python -m resdepth_tpu_torch.studies.narrow_ablation
        [--kernel narrow|narrow_k|wide_f32] [--json OUT.json]

``--kernel narrow`` (the default): beside the kernel as it is ("whole"),
copies of ``csrc/conv.cu`` whose narrow kernel lacks its products
("no_mma": the ``mma`` lines), its products and their A-fragment loads
("no_mma_ldm": and the ``ldmatrix`` lines), its split into the bf16 buffers
("no_split"), or all of them ("loads_only": what is left is the kernel's
loads, its weights' loads and its epilogue), at the composed top's two
convs at batch 128 (256² 64->1 and 128² 64->4).

``--kernel narrow_k``: the narrow_k kernel whole, without its products
("no_mma": the compiler then drops the gathers and the split they feed,
so what is left is the halo loads and the stores), without its split of
the gathered values ("no_split"), without its halo loads ("no_loads":
the gathers read whatever the stages hold), and with nothing but its stores
("stores_only": no halo loads, gathers, split or products; the epilogue
writes bias and activation of zeros), at encoder0's shape (batch 128,
256², 3->64) and the last conv's dx in training (batch 20, 256², 1->64).

``--kernel wide_f32``: the wide_f32 kernel whole, without its products
("no_mma": the ``wgmma`` lines), without its split of x into the bf16
sets ("no_split"), without x's halo loads ("no_loads": the split reads
whatever the stages hold), without the weights' loads ("no_wloads": the
products read whatever the weight stages hold), and with nothing but its
stores ("stores_only": none of those and no ``ldmatrix``; the epilogue
writes bias and activation of zeros), at three trunk convs at batch 128
(128² 64->128, 64² 256->128 and 8² 512->512), NHWC memory (what the
served model hands it), at 1 and 2 passes.

Beside each row, one ``Tensor.fill_`` of the output: a plain write of the
output's bytes.

Each cut is built with the package's nvcc flags and timed with CUDA
events (10 launches after 3), with x as NHWC memory and (narrow, narrow_k)
as the NHWC view of NCHW memory, at 1, 2 and 3 passes (wide_f32: 1 and 2),
beside the bound: the larger of the bytes (x, weights, bias and slopes
read once, the output written once, at 3.35 TB/s) and the bf16 products
(2 N H W 9 Cin Cout a pass at 989 TFLOP/s). A cut kernel computes nothing
useful: only its time is read. Needs the card (nvcc, sm_90a); the
libraries go to ``build/resdepth_tpu_torch/ablation/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from resdepth_tpu_torch.ops import build, conv

PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12

_MMA = re.compile(r"^\s*(if constexpr \([^)]*\) )?mma_16816\(acc\[i\].*$", re.M)
_LDMATRIX = re.compile(r"^\s*(if constexpr \([^)]*\) )?ldmatrix_x4\(a.*$", re.M)
_SPLIT = re.compile(r"split_chunk<kLoad, \(kPasses >= 2\)>\([^;]*;", re.S)
# the narrow_k kernel's products, split, gathers and halo loads
_K_MMA = re.compile(r"^\s*(if constexpr \([^)]*\) )?narrow::mma_16816\(acc\[nt\].*$", re.M)
_K_SPLIT = re.compile(r"^\s*split_a\(v0, v1, ah, al\);$", re.M)
_K_GATHER = re.compile(r"^\s*v[01]\[i\] = ok \? hs\[.*$", re.M)
_K_LOADS = re.compile(r"^\s*load_halo\(smem_u32.*$", re.M)
# the wide_f32 kernel's products, A loads, split, x's loads (the issue and
# the wait of each chunk) and the weights' loads (the producer's loads and
# the consumers' wait)
_W_MMA = re.compile(r"^\s*(if constexpr \([^)]*\) )?wgmma_rs<BN>\(acc.*$", re.M)
_W_LDMATRIX = re.compile(r"^\s*(if constexpr \([^)]*\) )?narrow::ldmatrix_x4\(a[hl]\[.*$",
                         re.M)
_W_SPLIT = re.compile(r"^\s*split_x<\(kPasses >= 2\)>\(stage.*$", re.M)
_W_LOADS = re.compile(r"^\s*(for \(int j = 0; j < C::kXStages; \+\+j\) )?(issue_x|landed_x)\(j.*$",
                      re.M)
_W_WLOADS = re.compile(r"^\s*tma_load_3d\(dst.*$", re.M)
# ... and the bytes the weight stage's barrier waits for: none, so that the
# producer's arrival alone completes it and the ring keeps its order
_W_WBYTES = (re.compile(r"mbar_expect_tx\(wfull\(ws\), C::kWStageBytes\)"),
             "mbar_expect_tx(wfull(ws), 0)")
# each kernel: its C entry, its shapes (N, H, W, Cin, Cout), its cuts as
# the patterns each removes, its layouts of x and its pass counts
KERNELS = {
    "narrow": ("conv3x3_k3_narrow", ((128, 256, 256, 64, 1), (128, 128, 128, 64, 4)),
               {"whole": (), "no_mma": (_MMA,), "no_mma_ldm": (_MMA, _LDMATRIX),
                "no_split": (_SPLIT,), "loads_only": (_MMA, _LDMATRIX, _SPLIT)},
               ("nhwc", "nchw"), (1, 2, 3)),
    "narrow_k": ("conv3x3_k3_narrow_k", ((128, 256, 256, 3, 64), (20, 256, 256, 1, 64)),
                 {"whole": (), "no_mma": (_K_MMA,), "no_split": (_K_SPLIT,),
                  "no_loads": (_K_LOADS,),
                  "stores_only": (_K_MMA, _K_SPLIT, _K_GATHER, _K_LOADS)},
                 ("nhwc", "nchw"), (1, 2, 3)),
    "wide_f32": ("conv3x3_k3_wide_f32",
                 ((128, 128, 128, 64, 128), (128, 64, 64, 256, 128), (128, 8, 8, 512, 512)),
                 {"whole": (), "no_mma": (_W_MMA,), "no_split": (_W_SPLIT,),
                  "no_loads": (_W_LOADS,), "no_wloads": (_W_WLOADS, _W_WBYTES),
                  "stores_only": (_W_MMA, _W_LDMATRIX, _W_SPLIT, _W_LOADS, _W_WLOADS,
                                  _W_WBYTES)},
                 ("nhwc",), (1, 2)),
}


def cut_sources(source: str, kernel: str = "narrow") -> dict:
    """``{name: source}`` for each cut of ``kernel`` (``KERNELS``): each
    pattern's matches removed, or replaced where it comes as ``(pattern,
    replacement)``; raises when a pattern no longer finds its lines in
    ``source``."""
    out = {}
    for name, patterns in KERNELS[kernel][2].items():
        text = source
        for pattern in patterns:
            pattern, replacement = pattern if isinstance(pattern, tuple) else (pattern, "")
            text, n = pattern.subn(replacement, text)
            if n == 0:
                raise ValueError(f"{name}: {pattern.pattern!r} finds nothing in conv.cu")
        out[name] = text
    return out


def _build(name: str, text: str) -> str:
    directory = os.path.join(build.BUILD_DIR, "ablation")
    os.makedirs(directory, exist_ok=True)
    source, target = os.path.join(directory, f"{name}.cu"), os.path.join(directory,
                                                                         f"lib{name}.so")
    with open(source, "w") as f:
        f.write(text)
    result = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", target, source],
                            capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError(f"nvcc failed for the {name} cut:\n{result.stderr}")
    return target


def _ms(fn, iters: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(kernel_name: str = "narrow") -> list:
    """Build every cut of ``kernel_name`` (one nvcc each, at once) and time
    them; one row a shape, layout and pass count."""
    entry, shapes, cuts, layouts, pass_counts = KERNELS[kernel_name]
    with open(os.path.join(build.CSRC, "conv.cu")) as f:
        sources = cut_sources(f.read(), kernel_name)
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(lambda kv: _build(f"{kernel_name}_{kv[0]}", kv[1]),
                                           sources.items())))
    libs = {}
    for name, path in paths.items():
        fn = getattr(ctypes.CDLL(path), entry)
        fn.argtypes, fn.restype = conv.NARROW_ARGTYPES, ctypes.c_int
        libs[name] = fn
    generator = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for n, h, w, c_in, c_out in shapes:
        x_nhwc = torch.randn((n, h, w, c_in), generator=generator, device="cuda")
        kernel = torch.randn((3, 3, c_in, c_out), generator=generator, device="cuda")
        zeros = torch.zeros(c_out, device="cuda")
        out = torch.empty((n, h, w, c_out), device="cuda")
        n_bytes = (x_nhwc.numel() + 9 * c_in * c_out + out.numel()) * 4 + 8 * c_out
        for layout in layouts:
            x = (x_nhwc if layout == "nhwc"
                 else x_nhwc.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))
            for passes in pass_counts:
                frags = torch.empty(conv._fragment_bytes(kernel_name, c_in, c_out, passes),
                                    dtype=torch.uint8, device="cuda")
                n_ops = passes * 2.0 * n * h * w * 9 * c_in * c_out
                row = {"shape": [n, h, w, c_in, c_out], "layout": layout, "passes": passes,
                       "bound_ms": max(n_bytes / PEAK_BYTES, n_ops / PEAK_BF16) * 1e3}
                for name, fn in libs.items():
                    def call(fn=fn, name=name):
                        code = fn(x.data_ptr(), *x.stride(), kernel.data_ptr(),
                                  *kernel.stride(), frags.data_ptr(), zeros.data_ptr(),
                                  zeros.data_ptr(), out.data_ptr(), n, h, w, c_in, c_out, 0,
                                  passes, torch.cuda.current_stream().cuda_stream)
                        if code != 0:
                            raise RuntimeError(f"the {name} cut failed to launch: {code}")

                    row[name] = _ms(call)
                row["fill"] = _ms(lambda: out.fill_(1.0))
                rows.append(row)
                print(f"{kernel_name} {n}x{h}x{w} {c_in}->{c_out} {layout} {passes}p: bound "
                      f"{row['bound_ms']:.3f} ms; " + ", ".join(
                          f"{k} {row[k]:.3f}" for k in (*cuts, "fill")), flush=True)
        del x_nhwc, x, out, frags
    return rows


def main(argv: list | None = None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", choices=tuple(KERNELS), default="narrow",
                        help="the variant to cut (default narrow)")
    parser.add_argument("--json", help="write the rows here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("narrow_ablation: the cuts run on the card only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(card.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    rows = run(args.kernel)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
