"""Device helpers shared by the registration and the serving code.

``resolve_device`` turns a caller's ``device`` into a ``torch.device`` and
refuses CUDA on a host without a card; ``as_volume`` puts a caller's volume
(or stack of volumes) there as contiguous float32, and ``synchronize`` ends
a timed call; ``card_name`` is the card's name and
power limit as ``nvidia-smi`` prints them; ``traced`` and
``device_ms_by_name`` run a call under ``torch.profiler`` and sum its device
time per kernel name, and ``resident_blocks`` a kernel's occupancy, for the
profiling scripts.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

__all__ = ["as_volume", "card_name", "device_ms_by_name", "resident_blocks",
           "resolve_device", "synchronize", "traced"]

_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]


def resolve_device(device, what="the registration") -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA on a host without a
    card, naming ``what`` runs there.

    There is no silent CPU path: the CPU runs only when the caller asks.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: {what} runs on the card; pass "
            "device='cpu' to run the kernels' plain versions on the CPU")
    return device


def as_volume(x, device) -> torch.Tensor:
    """``x`` (a tensor or an array) as a contiguous float32 tensor on
    ``device``."""
    if not isinstance(x, torch.Tensor):  # copy: numpy views of JAX arrays are read-only
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32).contiguous()


def synchronize(device):
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_name():
    """``"<name>, <power limit>"`` of the first card, from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def traced(fn):
    """``(profile, wall seconds)`` of one call of ``fn``."""
    with torch.profiler.profile(activities=_ACTIVITIES) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    return prof, wall


def device_ms_by_name(prof):
    """Device milliseconds of a profile, summed per kernel name."""
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def resident_blocks(registers, smem_bytes, threads):
    """Blocks of ``threads`` threads that an H100 SM holds at ``registers``
    a thread and ``smem_bytes`` of shared memory a block (sm_90: 65536
    registers, allocated 256 a warp; 228 KB of shared memory, 1 KB of it
    reserved a block; 2048 threads, 32 blocks)."""
    warps = -(-threads // 32)
    by_regs = 65536 // (-(-registers * 32 // 256) * 256 * warps)
    return min(by_regs, 233_472 // (smem_bytes + 1024), 2048 // threads, 32)
