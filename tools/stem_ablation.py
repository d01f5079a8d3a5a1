#!/usr/bin/env python3
"""Where the stem's tensor-core backward kernels spend their time, by
ablation (for machines where ``ncu`` and ``nsys`` cannot run).

    python3 tools/stem_ablation.py            # on the card; needs nvcc

Builds ``podtpu_torch/csrc/stem_fused.cu`` as it is and in variants that
each cut one part out of ``bwd_tc_kernel`` (a variant's results are wrong
on purpose: only its time is read), one ``nvcc`` each, all started together,
into ``podtpu_torch/_build/ablation/``. Then times ``stem_bwd_sums`` and
``stem_bwd_dw`` of every build at the train step's shape (B=64, 416 px,
bf16; ``chip_smoke.py``'s inputs), 20 launches each, in two passes (the
builds in order, then in reverse), and prints one JSON line per build with
ptxas' registers, both times and whether its results equal the unchanged
build's bit for bit. Before them, one line with what ``cuobjdump -sass``
shows of the unchanged build: the instructions of each kernel's loop over
units (the innermost loop around its ``HMMA``), per unit, by opcode. The
last line is ``nvidia-smi``'s name and power limit.

Each variant is a textual patch of the source; a patch that no longer
applies raises, so the tool cannot silently time the wrong thing.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from podtpu_torch.ops.kernels import build  # noqa: E402
from podtpu_torch.ops.kernels import stem_kernel as sk  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "ablation")

# the epilogue, from the first use of the accumulators to product 2
EPILOGUE_FROM = "        // pre rounded once to bf16, then bn_apply() on pairs"
EPILOGUE_TO = "      // product 2: slots 8 nt .. 8 nt + 7 are row ky"
NO_EPILOGUE = '''        float pre[4], y[4];
        if constexpr (kDw) {
          af[m][hf] = pack_bf16x2(acc[m][0][2 * hf] + gv, acc[m][0][2 * hf + 1]);
          af[m][2 + hf] = pack_bf16x2(acc[m][1][2 * hf], acc[m][1][2 * hf + 1]);
        } else {
          sum_d[i] += acc[m][0][2 * hf] + acc[m][1][2 * hf + 1] + gv;
          sum_dx[i] += acc[m][0][2 * hf + 1] + acc[m][1][2 * hf];
        }
        (void)pre; (void)y; (void)inside;
      }

'''

# name -> (what it shows, [(old, new), ...])
PATCHES = {
    "unchanged": ("the kernels as they are", []),
    "units_unrolled_alike": ("two units of a warp in flight in bwd_dw "
                             "too (as in bwd_sums)", [(
        "#pragma unroll(kDw ? 1 : 2)\n    for (int u = 0; u < 8; ++u)",
        "#pragma unroll 2\n    for (int u = 0; u < 8; ++u)")]),
    "no_epilogue": ("the accumulators go straight into product 2 or the "
                    "sums: what the float32 epilogue costs", None),
    "no_product_1": ("the conv's mma replaced by one add: what product 1 "
                     "costs", [(
        "            mma_bf16(acc[m][dy], wf[m][ky], nb[dy + ky][0], "
        "nb[dy + ky][1]);",
        "            acc[m][dy][ky] += __uint_as_float((nb[dy + ky][0] ^ "
        "wf[m][ky][1]) & 0x3fffffffu);")]),
    "no_product_2": ("dW's mma replaced by one add: what product 2 costs", [(
        "            mma_bf16(dw[m][nt], af[m], tb[nt >> 1][nt & 1],\n"
        "                     tb[(nt >> 1) + 1][nt & 1]);",
        "            dw[m][nt][0] += __uint_as_float(af[m][nt & 3] ^ "
        "tb[nt >> 1][nt & 1]);")]),
    "stage_first_tile_only": ("raw rows -> 4-channel copies only once a "
                              "block: what the staging pass costs", [(
        "    stage_tile(x, s, tl, raw + stage * kRawBytes, xa, xb);",
        "    if (t == blockIdx.x) stage_tile(x, s, tl, raw + stage * "
        "kRawBytes, xa, xb);")]),
    "load_first_tile_only": ("no cp.async after a block's first tile: what "
                             "the loads cost beyond what compute hides", [(
        "    if (t + gridDim.x < s.tiles)\n      start_tile_loads",
        "    if (false)\n      start_tile_loads")]),
}


def variants() -> dict[str, str]:
    with open(os.path.join(build.CSRC_DIR, "stem_fused.cu")) as f:
        src = f.read()
    out = {}
    for name, (_, patches) in PATCHES.items():
        text = src
        if patches is None:  # the epilogue as a whole
            a, b = src.index(EPILOGUE_FROM), src.index(EPILOGUE_TO)
            head = src[:a]
            decl = "        float pre[4], y[4];\n"
            if not head.endswith(decl):
                raise RuntimeError("no_epilogue: the epilogue's head moved")
            text = head[:-len(decl)] + NO_EPILOGUE + src[b:]
        else:
            for old, new in patches:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: patch does not apply once")
                text = text.replace(old, new)
        out[name] = text
    return out


def unit_loop_sass(lib_path: str) -> dict:
    """{kernel: {"per_unit", "units_per_iteration", "by_opcode"}}: the SASS
    instructions in the innermost loop that holds all of a tensor-core
    kernel's HMMA (its loop over units), divided by the units an iteration
    handles (12 HMMA a unit in bwd_sums, 24 in bwd_dw)."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0]
        kernel = re.search(r"bwd_tc_kernelILb([01])E", name)
        if not kernel:
            continue
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,6})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)([^;]*);",
            fn)]
        hmma = [a for a, op, _ in ins if op.startswith("HMMA")]
        loops = []
        for a, op, rest in ins:
            to = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if to and int(to.group(1), 16) <= hmma[0] and a >= hmma[-1]:
                loops.append((a - int(to.group(1), 16), int(to.group(1), 16), a))
        _, first, last = min(loops)
        body = [op.split(".")[0] for a, op, _ in ins if first <= a <= last]
        dw = kernel.group(1) == "1"
        units = len(hmma) // (24 if dw else 12)
        out["bwd_dw" if dw else "bwd_sums"] = {
            "per_unit": len(body) / units, "units_per_iteration": units,
            "by_opcode": {k: v / units for k, v in
                          collections.Counter(body).most_common(14)}}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("stem_ablation: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in variants().items():
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        regs[name] = {k: v for k, v in cs.ptxas_report(log).items()
                      if "bwd_tc" in k}
        libs[name] = ctypes.CDLL(os.path.join(OUT, name + ".so"))

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    x, w, scale, bias, g = cs.stem_inputs(64, torch.bfloat16, dev, cs.SEED + 4)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    s_r = sk.stem_stats_reference(x, w)
    mean = s_r[0] / n
    var = (s_r[1] / n - mean * mean).clamp_min(0.0)
    rinv = torch.rsqrt(var + 1e-5)
    inv = rinv * scale
    mul, add = inv.to(x.dtype).float(), (bias - mean * inv).to(x.dtype).float()
    u_r = sk.stem_bwd_sums_reference(x, w, mul, add, mean, rinv, g)
    vecs = (mul, add, mean, rinv, inv, u_r[0] / n, u_r[1] / n)

    def use(name):  # point the wrappers at this build's entry points
        for k in ("bwd_sums", "bwd_dw"):
            fn = getattr(libs[name], f"podtpu_stem_{k}")
            fn.restype, fn.argtypes = ctypes.c_int, sk._ARGTYPES[k]
            sk._FNS[k] = fn

    sums = lambda: sk.stem_bwd_sums(x, w, *vecs[:4], g)  # noqa: E731
    dw = lambda: sk.stem_bwd_dw(x, w, *vecs, g)  # noqa: E731
    ms = {name: {"bwd_sums_ms": [], "bwd_dw_ms": []} for name in libs}
    outs = {}
    for name in list(libs) + list(libs)[::-1]:
        use(name)
        ms[name]["bwd_sums_ms"].append(cs.cuda_ms(sums, 20))
        ms[name]["bwd_dw_ms"].append(cs.cuda_ms(dw, 20))
        outs[name] = (sums(), dw())
    cs.emit({"unit_loop_sass": unit_loop_sass(
        os.path.join(OUT, "unchanged.so"))})
    for name in libs:
        same = [bool(torch.equal(a, b))
                for a, b in zip(outs[name], outs["unchanged"])]
        cs.emit({"variant": name, "shows": PATCHES[name][0], **ms[name],
                 "equal_to_unchanged": dict(zip(("bwd_sums", "bwd_dw"), same)),
                 "ptxas": regs[name]})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
