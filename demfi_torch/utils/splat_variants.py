"""Times source variants of the forward splat kernel on the card, for tuning.

    python -m demfi_torch.utils.splat_variants [variant ...]

Each variant is ``csrc/fwarp_splat.cu`` with a few constants or lines
replaced (the source tile, the shared box's size, the register cap, the
flush, the order of a thread's corners, lane pairs merged before the
shared atomics, warp-aggregated atomics, and diagnostic cuts that leave
work out), built with nvcc into a temporary
directory and called through ctypes on the main path's splat input: CFR's
C=2 flows of 7 instants at 352x640, from DeMFI-Net_rb(5,3)'s Stage I with
the flow head calibrated to 24 px and scaled by t, as ``chip_smoke.py``
makes them ("smooth"), and on i.i.d. uniform +-24 px flows of the same
shape ("noise"). Device milliseconds of the kernel alone on zeroed
outputs, timed as ``chip_smoke.py`` times a call (a cold call queued
behind a spin kernel), the share of blocks on the shared route, and
whether the result agrees with the plain version to 1e-5 of its largest
value (a diagnostic cut DIFFERS by design). Beside them: the wrapper's
zeroing of its outputs (one ``torch.zeros`` of both, against one each),
and what the flush must reduce: the (block, 4-target group) pairs that
the smooth flows touch.

A substitution that no longer applies to the source raises: the list
describes this source, update it with the kernel.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from demfi_torch.ops import kernels, warp

H, W = 352, 640
M = 8
FLOW_PX = 24.0
RTOL = 1e-5

# the shared route's adds, as in the source
SHARED_ADDS = """#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (!live[j]) continue;
    const int p = (y0 + j * kRows) * W + x;
    float wgt[4];
    int slot[4];   // offset in a plane of the box, or -1 outside the image
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ddr = k >> 1, ddc = k & 1;
      const int r = tr[j] + ddr, c = tc[j] + ddc;
      const float a = __fsub_rn(fr[j], (float)ddr);
      const float d = __fsub_rn(fc[j], (float)ddc);
      wgt[k] = expf(-__fadd_rn(__fmul_rn(a, a), __fmul_rn(d, d)));
      slot[k] = (r < 0 || r >= H || c < 0 || c >= W)
                    ? -1 : (r - rb) * bw + (c - cb);
    }
    for (int ch = 0; ch < C; ++ch) {
      const float v = src[(int64_t)ch * shw + p];
      float* plane = box + ch * area;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (slot[k] >= 0) atomicAdd(plane + slot[k], __fmul_rn(v, wgt[k]));
    }
    float* plane = box + C * area;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (slot[k] >= 0) atomicAdd(plane + slot[k], wgt[k]);
  }
"""
# the variants that work across a warp's lanes take one pixel per thread,
# every lane present: the weights and slots of pixel 0, slot -1 if dead
WARP_PROLOGUE = """  {
    static_assert(kPix == 1, "a warp-wide variant: one pixel per thread");
    const int p = y0 * W + x;
    const bool lv = live[0];
    float wgt[4];
    int slot[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ddr = k >> 1, ddc = k & 1;
      const int r = tr[0] + ddr, c = tc[0] + ddc;
      const float a = __fsub_rn(fr[0], (float)ddr);
      const float d = __fsub_rn(fc[0], (float)ddc);
      wgt[k] = expf(-__fadd_rn(__fmul_rn(a, a), __fmul_rn(d, d)));
      slot[k] = (!lv || r < 0 || r >= H || c < 0 || c >= W)
                    ? -1 : (r - rb) * bw + (c - cb);
    }
    const int lane = tid & 31;
"""
# lane i's right corners are lane i + 1's left corners where the two have
# the same integer flow: lane i + 1 adds them to its own before the
# atomics
PAIR_MERGE = WARP_PROLOGUE + """    const int ntr = __shfl_down_sync(0xffffffffu, tr[0], 1);
    const int ntc = __shfl_down_sync(0xffffffffu, tc[0], 1);
    const int nlive = __shfl_down_sync(0xffffffffu, (int)lv, 1);
    const bool give = lv && nlive && lane < 31 && ntr == tr[0] &&
                      ntc == tc[0] + 1;
    const bool take = __shfl_up_sync(0xffffffffu, (int)give, 1) && lane > 0;
    for (int ch = 0; ch <= C; ++ch) {
      const float v = ch < C && lv ? src[(int64_t)ch * shw + p] : 1.0f;
      float val[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        val[k] = ch < C ? __fmul_rn(v, wgt[k]) : wgt[k];
      const float in1 = __shfl_up_sync(0xffffffffu, val[1], 1);
      const float in3 = __shfl_up_sync(0xffffffffu, val[3], 1);
      if (take) {
        val[0] = __fadd_rn(val[0], in1);
        val[2] = __fadd_rn(val[2], in3);
      }
      float* plane = box + ch * area;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (slot[k] >= 0 && !(give && (k & 1)))
          atomicAdd(plane + slot[k], val[k]);
    }
  }
"""
# the lanes of a warp with one slot in the box add their values together
# and one of them issues the shared atomic: no compare-and-swap conflicts
# inside an instruction
SHARED_MATCH = WARP_PROLOGUE + """#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = slot[k];
      const unsigned grp = __match_any_sync(0xffffffffu, s);
      const bool lead = lane == __ffs(grp) - 1;
      const bool alone = grp == (1u << lane);
      for (int ch = 0; ch <= C; ++ch) {
        const float v = s < 0 ? 0.0f
                        : ch < C ? __fmul_rn(src[(int64_t)ch * shw + p], wgt[k])
                                 : wgt[k];
        float sum = v;
        if (!alone && s >= 0) {
          sum = 0.0f;
          for (unsigned m = grp; m; m &= m - 1)
            sum = __fadd_rn(sum, __shfl_sync(grp, v, __ffs(m) - 1));
        }
        if (s >= 0 && lead) atomicAdd(box + ch * area + s, sum);
      }
    }
  }
"""
GLOBAL_ROUTE = """#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (!live[j]) continue;
      const int p = (y0 + j * kRows) * W + x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ddr = k >> 1, ddc = k & 1;
        const int r = tr[j] + ddr, c = tc[j] + ddc;
        if (r < 0 || r >= H || c < 0 || c >= W) continue;
        const float a = __fsub_rn(fr[j], (float)ddr);
        const float d = __fsub_rn(fc[j], (float)ddc);
        const float wgt = expf(-__fadd_rn(__fmul_rn(a, a), __fmul_rn(d, d)));
        const int t = r * W + c;
        for (int ch = 0; ch < C; ++ch)
          atomicAdd(dst + (int64_t)ch * hw + t,
                    __fmul_rn(src[(int64_t)ch * shw + p], wgt));
        atomicAdd(nrm + t, wgt);
      }
    }
"""
# the lanes of a warp with one target add their values together and one
# of them issues the atomic (__match_any_sync)
GLOBAL_MATCH = """    {
      static_assert(kPix == 1, "a warp-wide variant: one pixel per thread");
      const int p = y0 * W + x;
      const int lane = tid & 31;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ddr = k >> 1, ddc = k & 1;
        const int r = tr[0] + ddr, c = tc[0] + ddc;
        const bool valid = live[0] && r >= 0 && r < H && c >= 0 && c < W;
        const float a = __fsub_rn(fr[0], (float)ddr);
        const float d = __fsub_rn(fc[0], (float)ddc);
        const float wgt = expf(-__fadd_rn(__fmul_rn(a, a), __fmul_rn(d, d)));
        const int t = valid ? r * W + c : -1;
        const unsigned grp = __match_any_sync(0xffffffffu, t);
        const bool leader = lane == __ffs(grp) - 1;
        for (int ch = 0; ch <= C; ++ch) {
          const float v = !valid ? 0.0f
                          : ch < C ? __fmul_rn(src[(int64_t)ch * shw + p], wgt)
                                   : wgt;
          float sum = v;
          if (grp != (1u << lane) && valid) {
            sum = 0.0f;
            for (unsigned m = grp; m; m &= m - 1)
              sum = __fadd_rn(sum, __shfl_sync(grp, v, __ffs(m) - 1));
          }
          if (valid && leader)
            atomicAdd(ch < C ? dst + (int64_t)ch * hw + t : nrm + t, sum);
        }
      }
    }
"""
FLUSH_LOOP = "  for (int g = tid; g < groups; g += kThreads) {"
IMG_ADD = "atomicAdd(plane + slot[k], __fmul_rn(v, wgt[k]))"
NORM_ADD = "atomicAdd(plane + slot[k], wgt[k])"


def red_shared(value):
    return ('asm volatile("red.shared.add.f32 [%0], %1;" :: "r"((unsigned)'
            '__cvta_generic_to_shared(plane + slot[k])), "f"(' + value +
            ') : "memory")')


SLOTS_DONE = """                    ? -1 : (r - rb) * bw + (c - cb);
    }
    for (int ch = 0; ch < C; ++ch) {"""
STAGGER = [(SLOTS_DONE, SLOTS_DONE.replace("    }\n    for", """    }
    if (threadIdx.y & 1) {
      int s = slot[0]; slot[0] = slot[2]; slot[2] = s;
      s = slot[1]; slot[1] = slot[3]; slot[3] = s;
      float w = wgt[0]; wgt[0] = wgt[2]; wgt[2] = w;
      w = wgt[1]; wgt[1] = wgt[3]; wgt[3] = w;
    }
    for"""))]


def consts(**kw):
    """Substitutions of the source's constants, as in kPix=2."""
    out = []
    for name, value in kw.items():
        old = {"kPix": "kPix = 1;", "kRows": "kRows = 8;",
               "kBoxFloats": "kBoxFloats = 6144 * kPix;",
               "kMinBlocks": "kMinBlocks = 6;"}[name]
        out.append((old, old.split("=")[0] + f"= {value};"))
    return out


VARIANTS = {
    "base": [],
    # the tile: 32 x (kRows * kPix) source pixels, kRows x 32 threads
    "rows4": consts(kRows=4),
    "rows16": consts(kRows=16, kMinBlocks=3),
    "px2": consts(kPix=2),
    "px2_rows4": consts(kPix=2, kRows=4),
    "px4_rows4": consts(kPix=4, kRows=4),
    # the shared box's size in floats (base: 6144, 24 KB)
    "box12k": consts(kBoxFloats=12032),
    "box24k": consts(kBoxFloats=24576),
    # blocks an SM must hold (base: 6, 40 registers); 1 lifts the cap
    "blocks1": consts(kMinBlocks=1),
    "blocks5": consts(kMinBlocks=5),
    "blocks8": consts(kMinBlocks=8),
    # odd thread rows add their bottom corners first, so that two
    # neighbouring rows do not hit one target row at once
    "stagger": STAGGER,
    "scalar_flush": [("    if (vec) {", "    if (false) {")],
    "pair_merge": [(SHARED_ADDS, PAIR_MERGE)],
    "shared_match": [(SHARED_ADDS, SHARED_MATCH)],
    "red_shared": [(IMG_ADD, red_shared("__fmul_rn(v, wgt[k])")),
                   (NORM_ADD, red_shared("wgt[k]"))],
    "global_match": [(GLOBAL_ROUTE, GLOBAL_MATCH)],
    # diagnostic cuts (wrong results): what each part of the work costs
    "cut_after_box": [
        ("  const float* src = img + (int64_t)b * C * shw;\n",
         "  const float* src = img + (int64_t)b * C * shw;\n"
         "  if (area < 0) box[0] = src[0];\n  return;\n")],
    "cut_flush": [(FLUSH_LOOP, FLUSH_LOOP.replace("g < groups", "g < 0"))],
    "cut_shared_atomics": [
        (IMG_ADD, "plane[slot[k]] = __fmul_rn(v, wgt[k])"),
        (NORM_ADD, "plane[slot[k]] = wgt[k]")],
}


def build(names, tmp: Path):
    src = (kernels.CSRC / kernels.SOURCES["fwarp_splat"]).read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"{name}:\n{log}")
        lib = kernels._bind("fwarp_splat", ctypes.CDLL(str(tmp / f"{name}.so")))
        regs = ",".join(re.findall(r"Used (\d+) registers", log))
        spills = ",".join(re.findall(r"(\d+) bytes spill stores", log))
        libs[name] = (lib, f"{regs} registers, {spills} B spill stores")
    return libs


def main_path_flows(dev):
    """(img, flo) of the main path's CFR splat, as chip_smoke.py makes
    them: x8 DeMFI-Net_rb(5,3), seeded weights and frames, the flow head
    calibrated to 24 px, flo = t * flow_01 over the 7 instants."""
    from demfi_torch.config import config_rb
    from demfi_torch.models import make_model
    from demfi_torch.utils.profiling import calibrate_flow_head
    model = make_model(config_rb(5, 3, seed=0), device=dev)
    frames = np.random.RandomState(0).uniform(
        -1, 1, (1, 4, H, W, 3)).astype(np.float32)
    fr_t = torch.from_numpy(frames).to(dev).permute(0, 1, 4, 2, 3)
    with torch.no_grad():
        calibrate_flow_head(model, fr_t, FLOW_PX)
        ctx = model.extract(fr_t)
    t = (torch.arange(1, M, device=dev, dtype=torch.float32) / M).reshape(
        M - 1, 1, 1, 1)
    img = ctx.flow_01.expand(M - 1, -1, -1, -1).contiguous()
    return img, (t * img).contiguous()


def flush_groups(flo, tile=(8, 32)):
    """(block, group of 4 targets) pairs that a splat of flo touches: the
    16-byte reductions per plane of the flush, were every block on the
    shared route; and the corners in the image (the parent's scalar
    reductions per plane)."""
    b, _, h, w = flo.shape
    dev = flo.device
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None]
    r0 = torch.floor(flo[:, 1]) + ys
    c0 = torch.floor(flo[:, 0]) + xs
    block = ((torch.arange(b, device=dev)[:, None, None] * h + ys)
             // tile[0] * w + xs) // tile[1]
    keys, corners = [], 0
    for dr in (0, 1):
        for dc in (0, 1):
            r, c = r0 + dr, c0 + dc
            ok = (r >= 0) & (r < h) & (c >= 0) & (c < w)
            corners += int(ok.sum())
            grp = (r[ok].long() * w + c[ok].long()) // 4
            keys.append(block.expand_as(ok)[ok] * (h * w // 4) + grp)
    return int(torch.unique(torch.cat(keys)).numel()), corners


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("splat_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from chip_smoke import DeviceTimer       # the repository's timing
    names = argv or list(VARIANTS)
    dev = torch.device("cuda")
    img, smooth = main_path_flows(dev)
    noise = torch.from_numpy(np.random.RandomState(3).uniform(
        -FLOW_PX, FLOW_PX, tuple(smooth.shape)).astype(np.float32)).to(dev)
    flows = {"smooth": smooth, "noise": noise}
    b, c = img.shape[:2]
    want = {k: warp.fwarp_splat_plain(img, f) for k, f in flows.items()}
    out = torch.zeros_like(img)
    norm = torch.zeros((b, 1, H, W), device=dev)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    timer = DeviceTimer(torch)

    def call(lib, flo, route_stats=None):
        rc = lib.demfi_fwarp_splat_f32(
            img.data_ptr(), flo.data_ptr(), out.data_ptr(), norm.data_ptr(),
            None, None, None if route_stats is None else route_stats.data_ptr(),
            b, c, H, W, H, 0, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"cudaError {rc}")

    print(torch.cuda.get_device_name(0))
    groups, corners = flush_groups(smooth)
    print(f"smooth flows: {groups} (block, 4-target group) pairs touched: "
          f"{groups * (c + 1) / 1e6:.3f} M 16-byte reductions if every block "
          f"flushed a box; the parent's scalar reductions: {corners} corners "
          f"in the image x {c + 1} planes = {corners * (c + 1) / 1e6:.3f} M")
    one_ms = timer.ms(lambda: kernels._fwarp_outputs(img, torch.zeros), 10)
    two_ms = timer.ms(lambda: (torch.zeros_like(img),
                               torch.zeros((b, 1, H, W), device=dev)), 10)
    print(f"zeroed outputs: one torch.zeros of both (the wrapper's) "
          f"{one_ms:.4f} ms; two torch.zeros {two_ms:.4f} ms")
    with tempfile.TemporaryDirectory(prefix="splat_variants_") as tmp:
        libs = build(names, Path(tmp))
        first = next(iter(libs.values()))[0]
        for flo in flows.values():                     # warm-up, not shown
            timer.ms(lambda: call(first, flo), 10)
        print("variant (registers, spills) | " + " | ".join(
            f"{k} ms, shared share" for k in flows) + "   [device ms]")
        for name, (lib, regs) in libs.items():
            cells = []
            for key, flo in flows.items():
                out.zero_()
                norm.zero_()
                stats.zero_()
                call(lib, flo, stats)
                torch.cuda.synchronize()
                wo, wn = want[key]
                scale = max(1.0, float(wo.abs().max()), float(wn.abs().max()))
                err = max(float((out - wo).abs().max()),
                          float((norm - wn).abs().max()))
                shared, global_blocks = (int(v) for v in stats.cpu())
                ms = timer.ms(lambda: call(lib, flo), 10)
                cells.append(f"{ms:.4f}, "
                             f"{shared / max(1, shared + global_blocks):.3f}"
                             + ("" if err <= RTOL * scale else " DIFFERS"))
            print(f"{name} ({regs}) | " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
