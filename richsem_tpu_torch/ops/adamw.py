"""The optimizer's global norm and AdamW update over every leaf at once
(counterparts of the norm and the update of ``richsem_tpu/train/optim.py``,
which XLA fuses into the jitted train step).

* :func:`global_norm_clip` (K5, ``csrc/adamw.cu:sumsq_kernel`` and its
  finish): the float64 sum of the f32-rounded squares of every gradient ->
  ``gnorm = float32(sqrt(sum))`` and the clip state ``[gnorm, clip]``, with
  ``clip = 1 if gnorm < max_norm else max_norm / gnorm`` (``fused_adamw``'s
  factor; the chain divides by ``gnorm`` itself). A ``None`` gradient is a
  zero one.
* :func:`adamw_update` (K6, ``csrc/adamw.cu:adamw_kernel``): m, v and the
  parameter of every trainable leaf updated in place, in one of two orders
  (``ORDERS``), each operation rounded on its own as JAX rounds it:

  - ``"chain"``, the optax chain (``optim.py:178-184``):
    ``g' = g if gnorm < max_norm else (g / gnorm) * max_norm``;
    ``m = (1-b1) g' + b1 m``; ``v = (1-b2) (g' g') + b2 v``;
    ``u = (m / c1) / (sqrt(v / c2) + eps) + wd p``; ``u = u s`` where the
    group scale ``s != 1``; ``p = p - u lr``.
  - ``"fused"``, ``fused_adamw`` (``optim.py:123-147``): ``g' = g clip``;
    the same moments; ``p = p + ((-s) lr) ((m / c1) / (sqrt(v / c2) + eps) + wd p)``.

  ``lr``, ``c1 = 1 - b1^t`` and ``c2 = 1 - b2^t`` come from a device tensor
  ``hyper`` and gnorm and clip from K5's clip state, so no number that
  changes from step to step reaches a launch (a CUDA graph replays it).

On CPU tensors both run their plain versions; on CUDA tensors they check
their arguments, then launch their kernels or raise. Each wrapper's
``.launches`` counts the launches of its kernel (``sumsq_kernel`` for K5,
``adamw_kernel`` for K6). The leaf tables are kernel parameters built on the
host at each call (:func:`plan`), never copied to the device, so a CUDA
graph records them with the launch.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from richsem_tpu_torch.ops import _build

CHUNK = 65536  # elements a block (csrc/adamw.cu kChunk)
NORM_LEAVES = 1024  # entries of one K5 table (kNormLeaves)
ADAMW_LEAVES = 512  # entries of one K6 table (kAdamwLeaves)
ORDERS = ("chain", "fused")
_MAX_NUMEL = 2**31 - 1  # the tables count elements in int32


class Launch(NamedTuple):
    """One launch's table: the caller's indices of its leaves, the first
    chunk of each with the launch's chunk count at the end, and the index of
    its first chunk among all the launches' chunks."""

    leaves: Tuple[int, ...]
    first: Tuple[int, ...]
    chunk_base: int

    @property
    def chunks(self) -> int:
        return self.first[-1]


def plan(numels: Sequence[int], max_leaves: int, chunk: int = CHUNK) -> List[Launch]:
    """Cut leaves of ``numels`` elements into chunks of ``chunk``, a block
    each, and their table into launches of at most ``max_leaves`` entries. A
    leaf with no elements takes no chunk and enters no table."""
    out: List[Launch] = []
    leaves: List[int] = []
    first = [0]
    base = 0
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(leaves) == max_leaves:
            out.append(Launch(tuple(leaves), tuple(first), base))
            base += first[-1]
            leaves, first = [], [0]
        leaves.append(i)
        first.append(first[-1] + -(-n // chunk))
    if leaves:
        out.append(Launch(tuple(leaves), tuple(first), base))
    return out


def total_chunks(launches: Sequence[Launch]) -> int:
    return launches[-1].chunk_base + launches[-1].chunks if launches else 0


# ---------------------------------------------------------------- plain versions

def global_norm_clip_plain(grads: Sequence[Optional[torch.Tensor]], max_norm: float,
                           device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: each leaf's squares summed in float64, then the sum
    of those. -> (gnorm, clip state ``[gnorm, clip]``)."""
    sq = [torch.sum(g.float().square(), dtype=torch.float64) for g in grads if g is not None]
    total = (torch.stack(sq).sum() if sq
             else torch.zeros((), dtype=torch.float64, device=device))
    gnorm = total.sqrt().float()
    # max_norm / gnorm as a division of tensors: a Python number over a tensor
    # is a reciprocal times the number, another rounding
    clip = torch.where(gnorm < max_norm, torch.ones_like(gnorm),
                       torch.full_like(gnorm, max_norm) / gnorm)
    state = torch.stack([gnorm, clip])
    return state[0], state


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The f32 square root rounded once, as JAX's, numpy's and ``__fsqrt_rn``:
    taken in float64 and rounded to f32 (torch's vectorised f32 ``sqrt`` on
    the CPU is one f32 step off for about 0.65% of inputs, torch 2.13)."""
    return x.double().sqrt().float()


@torch.no_grad()
def adamw_update_plain(params, grads, mu, nu, hyper, clip_state, scales, *, b1: float,
                       b2: float, eps: float, weight_decay: float, max_norm: float,
                       order: str = "chain") -> None:
    """K6's plain version: the module docstring's two orders, leaf by leaf."""
    lr, c1, c2 = hyper.unbind()
    gnorm, clip = clip_state.unbind()
    keep = gnorm < max_norm
    for p, g, m, v, s in zip(params, grads, mu, nu, scales):
        g = torch.zeros_like(p) if g is None else g
        if order == "chain":
            g = torch.where(keep, g, (g / gnorm) * max_norm)
        else:
            g = g * clip
        m.copy_(g * (1.0 - b1) + m * b1)
        v.copy_((g * g) * (1.0 - b2) + v * b2)
        u = (m / c1) / (_sqrt_f32(v / c2) + eps) + p * weight_decay
        if order == "chain":
            if s != 1.0:  # the group scale, then the lr, as the chain
                u = u * s
            p.sub_(u * lr)
        else:
            p.add_((lr * -s) * u)


# ---------------------------------------------------------------- the kernels

_SRC = "adamw"


class _NormTable(ctypes.Structure):
    _fields_ = [("g", ctypes.c_void_p * NORM_LEAVES), ("count", ctypes.c_int * NORM_LEAVES),
                ("first", ctypes.c_int * (NORM_LEAVES + 1)), ("n_leaves", ctypes.c_int)]


class _AdamwTable(ctypes.Structure):
    _fields_ = [("g", ctypes.c_void_p * ADAMW_LEAVES), ("m", ctypes.c_void_p * ADAMW_LEAVES),
                ("v", ctypes.c_void_p * ADAMW_LEAVES), ("p", ctypes.c_void_p * ADAMW_LEAVES),
                ("count", ctypes.c_int * ADAMW_LEAVES),
                ("first", ctypes.c_int * (ADAMW_LEAVES + 1)),
                ("scale", ctypes.c_float * ADAMW_LEAVES), ("n_leaves", ctypes.c_int)]


class _AdamwConsts(ctypes.Structure):
    _fields_ = [(k, ctypes.c_float) for k in ("b1", "one_minus_b1", "b2", "one_minus_b2", "eps",
                                              "weight_decay", "max_norm")]


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SRC)
    if lib.adamw.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        abi = (ctypes.c_longlong * 7)()
        lib.adamw_abi.argtypes = [ptr]
        lib.adamw_abi(abi)
        want = (CHUNK, 512, NORM_LEAVES, ADAMW_LEAVES, ctypes.sizeof(_NormTable),
                ctypes.sizeof(_AdamwTable), ctypes.sizeof(_AdamwConsts))
        if tuple(abi) != want:
            raise RuntimeError(f"csrc/adamw.cu's layout {tuple(abi)} differs from "
                               f"ops/adamw.py's {want}")
        lib.sumsq.argtypes = [ptr, i32, ptr, ptr]
        lib.sumsq_finish.argtypes = [ptr, i32, ctypes.c_float, ptr, ptr]
        lib.adamw.argtypes = [ptr, i32, ptr, ptr, ptr, i32, ptr]
        for fn in (lib.sumsq, lib.sumsq_finish, lib.adamw):
            fn.restype = ctypes.c_int
    return lib


def _device(tensors: Sequence[torch.Tensor], device=None) -> torch.device:
    """The one device of ``tensors`` (``device`` when there are none)."""
    devices = {t.device for t in tensors}
    if device is not None:
        devices.add(torch.device(device))
    if len(devices) > 1:
        raise ValueError(f"the optimizer's tensors must share one device, got "
                         f"{sorted(map(str, devices))}")
    return devices.pop() if devices else torch.device("cpu")


def _check(what: str, tensors: Sequence[torch.Tensor]) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
        if t.numel() > _MAX_NUMEL:
            raise ValueError(f"{what} counts a leaf's elements in int32: {t.numel()} is too many")


def _err(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _norm_cuda(grads, max_norm: float, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    launches = plan([0 if g is None else g.numel() for g in grads], NORM_LEAVES)
    n = total_chunks(launches)
    partials = torch.empty(max(n, 1), dtype=torch.float64, device=dev)
    clip_state = torch.empty(2, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in launches:
            t = _NormTable()
            for i, j in enumerate(launch.leaves):
                g = grads[j]
                t.g[i], t.count[i], t.first[i] = g.data_ptr(), g.numel(), launch.first[i]
            t.first[len(launch.leaves)] = launch.chunks
            t.n_leaves = len(launch.leaves)
            _err("K5", lib.sumsq(ctypes.addressof(t), launch.chunks,
                                 partials.data_ptr() + 8 * launch.chunk_base, stream))
            global_norm_clip.launches += 1
        _err("K5 finish", lib.sumsq_finish(partials.data_ptr(), n, max_norm,
                                           clip_state.data_ptr(), stream))
    return clip_state[0], clip_state


def _update_cuda(params, grads, mu, nu, hyper, clip_state, scales, consts: _AdamwConsts,
                 order: str, dev: torch.device) -> None:
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in plan([p.numel() for p in params], ADAMW_LEAVES):
            t = _AdamwTable()
            for i, j in enumerate(launch.leaves):
                g = grads[j]
                t.g[i] = None if g is None else g.data_ptr()
                t.m[i], t.v[i], t.p[i] = mu[j].data_ptr(), nu[j].data_ptr(), params[j].data_ptr()
                t.count[i], t.first[i], t.scale[i] = params[j].numel(), launch.first[i], scales[j]
            t.first[len(launch.leaves)] = launch.chunks
            t.n_leaves = len(launch.leaves)
            _err("K6", lib.adamw(ctypes.addressof(t), launch.chunks, hyper.data_ptr(),
                                 clip_state.data_ptr(), ctypes.addressof(consts),
                                 ORDERS.index(order), stream))
            adamw_update.launches += 1


# ---------------------------------------------------------------- the wrappers

def global_norm_clip(grads: Sequence[Optional[torch.Tensor]], max_norm: float,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-clip global norm of ``grads`` (``None`` a zero leaf) ->
    (``gnorm`` 0-d f32, the clip state ``[gnorm, clip]`` f32 that
    :func:`adamw_update` reads). ``device`` is where the result lands when
    every gradient is ``None``. K5 on CUDA tensors, the plain version on CPU
    ones."""
    present = [g for g in grads if g is not None]
    dev = _device(present, device)
    if dev.type == "cpu":
        return global_norm_clip_plain(grads, max_norm, dev)
    if dev.type != "cuda":
        raise RuntimeError(f"global_norm_clip: no kernel for device {dev}")
    _check("K5", present)
    return _norm_cuda(grads, max_norm, dev)


def adamw_update(params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
                 mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor], hyper: torch.Tensor,
                 clip_state: torch.Tensor, scales: Sequence[float], *, b1: float, b2: float,
                 eps: float, weight_decay: float, max_norm: float, order: str = "chain") -> None:
    """AdamW over the trainable leaves, in place: ``params``, their ``grads``
    (``None`` a zero gradient), moments ``mu`` and ``nu``, group ``scales``;
    ``hyper`` = [lr, 1 - b1^t, 1 - b2^t] and ``clip_state`` (K5's) on their
    device; ``order`` one of ``ORDERS``. K6 on CUDA tensors, the plain version
    on CPU ones."""
    if order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, got {order!r}")
    lists = (params, grads, mu, nu, scales)
    if len({len(x) for x in lists}) != 1:
        raise ValueError(f"params, grads, mu, nu and scales differ in length: "
                         f"{[len(x) for x in lists]}")
    present = [g for g in grads if g is not None]
    dev = _device([*params, *present, *mu, *nu, hyper, clip_state])
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, max_norm=max_norm)
    if dev.type == "cpu":
        return adamw_update_plain(params, grads, mu, nu, hyper, clip_state, scales, order=order,
                                  **kw)
    if dev.type != "cuda":
        raise RuntimeError(f"adamw_update: no kernel for device {dev}")
    _check("K6", [*params, *present, *mu, *nu, hyper, clip_state])
    if hyper.shape != (3,) or clip_state.shape != (2,):
        raise ValueError(f"K6 takes hyper [3] and clip_state [2], got {tuple(hyper.shape)} "
                         f"and {tuple(clip_state.shape)}")
    for p, g, m, v in zip(params, grads, mu, nu):
        if m.shape != p.shape or v.shape != p.shape or (g is not None and g.shape != p.shape):
            raise ValueError(f"a leaf's gradient and moments must have its shape {tuple(p.shape)}")
    consts = _AdamwConsts(b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, max_norm)
    _update_cuda(params, grads, mu, nu, hyper, clip_state, scales, consts, order, dev)


global_norm_clip.launches = 0  # K5 launches (sumsq_kernel); chip_smoke.py reads and resets it
adamw_update.launches = 0  # K6 launches (adamw_kernel)
