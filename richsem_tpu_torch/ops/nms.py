"""Greedy NMS keep masks (counterpart of ``richsem_tpu/ops/nms.py``).

``nms_mask(boxes, scores, iou_threshold)`` -> ``keep [B, N]`` bool: the boxes
sorted by score (a stable sort: equal scores in index order), then for each
``i`` in that order, if box ``i`` is still kept, every later box whose IoU
with it is above the threshold is dropped; the mask comes back in the
original order. The IoU is ``utils/boxes.py:box_iou``'s, in f32.

* On CUDA tensors the hand-written kernel K7 (``csrc/nms.cu``, one
  thread-block cluster an image: ranks by lane counts and a warp sum, IoU
  words by ballot into the leading block's shared memory, a sweep over
  32-box words) runs, with the
  IoU rounded as ``box_iou`` rounds it; each launch adds one to
  ``nms_mask.launches``. It takes f32 boxes and scores and
  at most ``MAX_N`` boxes an image, and raises otherwise: there is no
  fallback.
* On CPU tensors :func:`nms_mask_plain` runs, the same loop in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from richsem_tpu_torch.ops import _build
from richsem_tpu_torch.utils.boxes import box_iou

_K7 = "nms"
MAX_N = 1024  # boxes an image: one 32-bit word of the keep mask a lane of one warp


def smem_bytes(n: int) -> int:
    """K7's dynamic shared memory for ``n`` boxes, the same in every block of
    a cluster: a box, a score, an area and an index each, and ``ceil(n / 32)``
    words of IoU bits a box, which only the leading block fills (``nms.cu``)."""
    return 28 * n + 4 * n * ((n + 31) // 32)


def nms_mask_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float
                   ) -> torch.Tensor:
    """The plain version: ``boxes [B, N, 4]`` xyxy, ``scores [B, N]`` ->
    ``keep [B, N]`` bool, the JAX loop step by step."""
    b, n = scores.shape
    order = torch.sort(-scores, dim=1, stable=True).indices
    sorted_boxes = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4))
    iou = torch.stack([box_iou(x, x)[0] for x in sorted_boxes])  # [B, N, N]
    later = torch.arange(n, device=scores.device)
    keep = torch.ones((b, n), dtype=torch.bool, device=scores.device)
    for i in range(n):
        suppress = (iou[:, i] > iou_threshold) & (later > i) & keep[:, i:i + 1]
        keep = keep & ~suppress
    return torch.zeros_like(keep).scatter(1, order, keep)


def _lib() -> ctypes.CDLL:
    lib = _build.load(_K7)
    if lib.nms_keep.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.nms_keep.argtypes = [ptr, ptr, ptr, i32, i32, ctypes.c_float, ptr, ptr]
        lib.nms_keep.restype = ctypes.c_int
        lib.nms_block_floor.argtypes = [i32, ptr, ptr, ptr]
        lib.nms_block_floor.restype = ctypes.c_int
    return lib


def _check_cuda(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if scores.dim() != 2 or boxes.shape != (*scores.shape, 4):
        raise ValueError(f"K7 takes boxes [B, N, 4] and scores [B, N], got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"K7 takes float32 boxes and scores, got {boxes.dtype} and "
                        f"{scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError("boxes and scores must share a device")
    if not 1 <= scores.shape[1] <= MAX_N:
        raise ValueError(f"K7 keeps an image's mask in one warp: 1 to {MAX_N} boxes, "
                         f"got {scores.shape[1]}")


def _nms_cuda(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              stamps: torch.Tensor = None) -> torch.Tensor:
    b, n = scores.shape
    keep = torch.empty((b, n), dtype=torch.bool, device=scores.device)
    if b == 0:
        return keep
    boxes, scores = boxes.contiguous(), scores.contiguous()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().nms_keep(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), b, n,
                              iou_threshold, None if stamps is None else stamps.data_ptr(),
                              stream)
    if err != 0:
        raise RuntimeError(f"K7 nms launch failed: CUDA error {err}")
    nms_mask.launches += 1
    return keep


PASSES = ("rank", "iou", "sweep", "scatter")  # K7's passes, in order, as its stamps split them


def pass_split(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               reps: int = 21) -> dict:
    """K7's passes timed apart: ``reps`` launches, each writing its stamps
    (``%globaltimer`` and ``clock64`` at the start and after each pass, from
    one thread of image 0's leading block) -> {pass: (ns, cycles)}, the
    median of each over the launches."""
    _check_cuda(boxes, scores)
    stamps = torch.zeros((reps, len(PASSES) + 1, 2), dtype=torch.int64, device=scores.device)
    for r in range(reps):
        _nms_cuda(boxes, scores, iou_threshold, stamps[r])
    d = stamps.diff(dim=1).double().median(dim=0).values.tolist()
    return {name: tuple(v) for name, v in zip(PASSES, d)}


def block_floor(steps: int = 1 << 16, device="cuda") -> dict:
    """One block step of K7's sweep alone on one warp
    (``nms.cu:block_floor_kernel``: 32 shuffles, the resolution chain and 32
    shared-memory loads) -> {"cycles", "ns"} a step. ``ceil(N / 32)`` such
    steps depend on each other: the sweep's latency floor."""
    out = torch.zeros(2, dtype=torch.int64, device=device)
    sink = torch.empty(32, dtype=torch.int32, device=device)
    with torch.cuda.device(out.device):
        err = _lib().nms_block_floor(steps, out.data_ptr(), sink.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K7 block floor launch failed: CUDA error {err}")
    cycles, ns = out.tolist()
    return {"cycles": cycles / steps, "ns": ns / steps}


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Keep masks: ``boxes [B, N, 4]`` xyxy (not sorted), ``scores [B, N]`` ->
    ``keep [B, N]`` bool. K7 on CUDA tensors, the plain version on CPU ones."""
    if scores.device.type == "cpu":
        return nms_mask_plain(boxes, scores, iou_threshold)
    if scores.device.type != "cuda":
        raise RuntimeError(f"nms: no kernel for device {scores.device}")
    _check_cuda(boxes, scores)
    return _nms_cuda(boxes, scores, iou_threshold)


nms_mask.launches = 0  # K7 launches; chip_smoke.py reads and resets it
