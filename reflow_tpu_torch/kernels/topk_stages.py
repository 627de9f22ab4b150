"""Where the top-k kernel's time goes, stage by stage, on a CUDA card.

Builds ``csrc/topk.cu`` once whole and once cut after each stage of the
cluster kernel (each cut copy returns there), and prints the device time
of both entries at their main-path shapes: ``topk`` on [256, 8208] and
``topk_merge`` on a carry of 16 plus a chunk of 8192. A stage's line is
the kernel cut after it, so the differences between lines are what each
stage adds. It also prints how many clusters of each size C can be
resident at once, which decides C: a 256-row launch runs in one wave
only while that count is at least 256. Run from the root of a checkout
on a machine with a card::

    python3 -m reflow_tpu_torch.kernels.topk_stages

The cut copies are built into a temporary directory and exist for this
measurement only: their outputs mean nothing.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from reflow_tpu_torch.kernels import _build
from reflow_tpu_torch.kernels.topk import topk_merge_plain, topk_plain

#: appended to the whole kernel's copy: the most clusters of `c` blocks
#: of either entry that the card holds at once
OCCUPANCY = r"""
extern "C" int max_clusters(int c, int merge) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * 256);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  cudaError_t e = merge
      ? cudaOccupancyMaxActiveClusters(
            &n, topk_cluster_kernel<MergeSource>, &cfg)
      : cudaOccupancyMaxActiveClusters(&n, topk_cluster_kernel<RowSource>,
                                       &cfg);
  return e == cudaSuccess ? n : -1;
}
"""

#: (label, the source line a cut is placed before, the cut)
STAGES = [
    ("launch only", "  // paired with the wait before this block writes",
     "  if (k == -5) vals[0] = 1.f;\n  return;\n"),
    ("+ loads, order keys, lane maxima", "    lanemax[tid] = mk;",
     "    if (mk == 12345u) vals[0] = 1.f;\n    return;\n"),
    ("+ threshold and filter", "    if (t0 + kTile < s1) {",
     "    if (count == -5) vals[0] = 1.f;\n    return;\n"),
    ("+ rank into block 0, cluster barrier", "  if (rank != 0) return;",
     "  return;\n"),
]


def _device_us(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("topk_stages: no CUDA device")
    with tempfile.TemporaryDirectory(prefix="topk_stages-") as tmp:
        return _run(Path(tmp))


def _run(tmp: Path) -> int:
    src = (_build.CSRC / "topk.cu").read_text()
    builds = []
    for i, (label, anchor, cut) in enumerate(STAGES + [("whole kernel",
                                                         None, None)]):
        text = src + OCCUPANCY if anchor is None else src
        if anchor is not None:
            if src.count(anchor) != 1:
                raise SystemExit(f"topk_stages: the cut point {anchor!r} "
                                 f"is not in topk.cu once")
            text = src.replace(anchor, cut + anchor)
        cu, so = tmp / f"stage{i}.cu", tmp / f"stage{i}.so"
        cu.write_text(text)
        builds.append((label, so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stderr=subprocess.PIPE, text=True)))
    g = torch.Generator(device="cuda").manual_seed(0)
    s = torch.randn((256, 16 + 8192), generator=g, device="cuda")
    cv = torch.sort(torch.randn((256, 16), generator=g, device="cuda"),
                    dim=1, descending=True).values
    ci = torch.randint(0, 1 << 20, (256, 16), generator=g, device="cuda",
                       dtype=torch.int32)
    sc = torch.randn((256, 8192), generator=g, device="cuda")
    live = torch.rand((8192,), generator=g, device="cuda") < 0.9
    vals = torch.empty((256, 16), device="cuda")
    ids = torch.empty((256, 16), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    want = topk_plain(s, 16), topk_merge_plain(cv, ci, sc, live, 8192)
    p, i = ctypes.c_void_p, ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"device time per call (torch.profiler), {card}")
    for label, so, proc in builds:
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed:\n{proc.stderr.read()}")
        lib = ctypes.CDLL(str(so))
        row, merge = lib.reflow_topk_f32, lib.reflow_topk_merge_f32
        row.argtypes = [p, p, p, i, i, i, i, p]
        merge.argtypes = [p, p, p, p, i, p, p, i, i, i, i, p]
        calls = [
            lambda: row(s.data_ptr(), vals.data_ptr(), ids.data_ptr(), 256,
                        16 + 8192, 16, 0, stream),
            lambda: merge(cv.data_ptr(), ci.data_ptr(), sc.data_ptr(),
                          live.data_ptr(), 8192, vals.data_ptr(),
                          ids.data_ptr(), 256, 8192, 16, 0, stream)]
        us = []
        for call, (wv, wi) in zip(calls, want):
            if call() != 0:
                raise SystemExit(f"{label}: launch failed")
            torch.cuda.synchronize()
            if label == "whole kernel" and not (torch.equal(vals, wv)
                                                and torch.equal(ids, wi)):
                raise SystemExit("the whole kernel disagrees with plain")
            us.append(_device_us(call))
        print(f"{label:40s} topk {us[0]:6.2f} us   topk_merge "
              f"{us[1]:6.2f} us", flush=True)
    occ = lib.max_clusters
    print("clusters resident at once by size C (topk, topk_merge): "
          + ", ".join(f"C={c}: {occ(c, 0)}, {occ(c, 1)}"
                      for c in range(1, 9)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
