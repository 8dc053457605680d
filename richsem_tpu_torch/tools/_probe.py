"""What the three probe modules share: dispatching a call to the kernel or to
its plain version, launching a probe kernel, and timing a call."""

from __future__ import annotations

import ctypes
import time
from typing import Callable, Sequence, Tuple

import torch

from richsem_tpu_torch.ops import _build

PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version); raises for any other device or a mix."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on several devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    return True


def aligned16(*tensors: torch.Tensor):
    """The tensors, each contiguous and starting on a 16-byte boundary, as a
    kernel that loads 16 bytes at a time needs them: one that is not is
    copied into a fresh tensor."""
    return [t if t.is_contiguous() and t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.contiguous_format) for t in tensors]


def launch(source: str, fn_name: str, argtypes: Sequence, device: torch.device, *args) -> None:
    """Call ``fn_name`` of ``csrc/<source>.cu`` on the current stream; raise on a
    CUDA error at launch."""
    fn = getattr(_build.load(source), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, PTR]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{source}.cu {fn_name} launch failed: CUDA error {err}")


def timeit(fn: Callable[[], torch.Tensor], device, n: int = 20,
           warmup: int = 2) -> Tuple[torch.Tensor, float]:
    """-> (the last output, seconds a call): CUDA events around ``n`` calls on
    the card, the host clock on the CPU."""
    for _ in range(warmup):
        out = fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        return out, (time.perf_counter() - t0) / n
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end) / 1e3 / n


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} ({device})"
    return str(device)
