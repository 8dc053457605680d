"""Plain reference of the RichSem / DINO detector's forward, in float32.

Functions over a flat dict ``P`` of float32 tensors, keyed by the names under
which the benchmark makes the weights (``benchmark/harness/weights.py``): the
ResNet-50 with frozen batch-norm or the Swin backbone, the four-level input
projections, the deformable encoder, two-stage query selection, the decoder
with iterative box refinement and the CLIP-text classifier, then the flat
top-``num_select`` of every (query, class) pair. Every product is a plain
``torch`` call in float32 with TF32 off (:func:`exact`); the deformable
sampler is ``F.grid_sample`` (Deformable DETR's ``ms_deform_attn_core_pytorch``)
and the encoder tail the composition LN1, FFN, LN2. Nothing of the measured
package is imported.

Images are channel-last ``[B, H, W, 3]`` with ``pad_mask [B, H, W]`` True on
padding. Batch items do not interact, so a caller may run images one at a time.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@contextlib.contextmanager
def exact():
    """float32 products without TF32, the caller's settings put back after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def dense(P: Params, name: str, x: Tensor) -> Tensor:
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))


def layer_norm(P: Params, name: str, x: Tensor, eps: float = 1e-5) -> Tensor:
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], eps)


def mlp(P: Params, name: str, x: Tensor, layers: int) -> Tensor:
    for i in range(layers):
        x = dense(P, f"{name}.layer{i}", x)
        if i < layers - 1:
            x = torch.relu(x)
    return x


def conv_nchw(P: Params, name: str, x: Tensor, stride: int = 1, padding=0) -> Tensor:
    return F.conv2d(x, P[f"{name}.weight"], P.get(f"{name}.bias"), stride, padding)


def frozen_bn(P: Params, name: str, x: Tensor, eps: float = 1e-5) -> Tensor:
    scale = P[f"{name}.weight"] / torch.sqrt(P[f"{name}.running_var"] + eps)
    shift = P[f"{name}.bias"] - P[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def inverse_sigmoid(x: Tensor, eps: float = 1e-3) -> Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps)) - torch.log((1.0 - x).clamp(min=eps))


def l2n(x: Tensor, eps: float = 1e-9) -> Tensor:
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + eps * eps)


def cxcywh_to_xyxy(b: Tensor) -> Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


# ---------------------------------------------------------------------------
# backbones
# ---------------------------------------------------------------------------
def resnet50(P: Params, prefix: str, images: Tensor) -> List[Tensor]:
    """torchvision-v1.5 ResNet-50 (stride on the 3x3) with frozen BN ->
    C3, C4, C5 channel-last."""
    x = images.permute(0, 3, 1, 2)
    x = torch.relu(frozen_bn(P, f"{prefix}.stem_bn", conv_nchw(P, f"{prefix}.stem_conv", x, 2, 3)))
    x = F.max_pool2d(x, 3, 2, 1)
    outs = []
    for stage, (blocks, stride) in enumerate(zip((3, 4, 6, 3), (1, 2, 2, 2))):
        for b in range(blocks):
            n = f"{prefix}.layer{stage + 1}_block{b}"
            s = stride if b == 0 else 1
            y = torch.relu(frozen_bn(P, f"{n}.bn1", conv_nchw(P, f"{n}.conv1", x)))
            y = torch.relu(frozen_bn(P, f"{n}.bn2", conv_nchw(P, f"{n}.conv2", y, s, 1)))
            y = frozen_bn(P, f"{n}.bn3", conv_nchw(P, f"{n}.conv3", y))
            if b == 0:
                x = frozen_bn(P, f"{n}.downsample_bn", conv_nchw(P, f"{n}.downsample_conv", x, s))
            x = torch.relu(x + y)
        if stage >= 1:
            outs.append(x.permute(0, 2, 3, 1))
    return outs


def _rel_index(ws: int, device) -> Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).reshape(-1).to(device)


def _shift_mask(hp: int, wp: int, ws: int, shift: int, device) -> Tensor:
    img = torch.zeros(hp, wp)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    wins = img.reshape(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = wins[:, :, None] - wins[:, None, :]
    return torch.where(diff == 0, 0.0, -100.0).to(device)


def swin(P: Params, prefix: str, images: Tensor, embed_dim: int, depths: Sequence[int],
         heads: Sequence[int], window: int) -> List[Tensor]:
    """Swin Transformer (4x4 patches, shifted windows with a relative position
    bias, patch merging) -> the LayerNorm'd outputs of stages 1, 2, 3. Patch
    merging concatenates each 2 x 2 neighbourhood row by row; a side that is
    not a multiple of the window is padded with zeros after ``norm1``."""
    x = images.permute(0, 3, 1, 2)
    h, w = x.shape[2:]
    ph, pw = (-h) % 4, (-w) % 4  # flax "SAME" at kernel 4, stride 4: the smaller half first
    x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    y = conv_nchw(P, f"{prefix}.patch_embed", x, 4).permute(0, 2, 3, 1)
    y = layer_norm(P, f"{prefix}.patch_norm", y)
    outs = []
    for stage, depth in enumerate(depths):
        dim, nh = embed_dim * 2 ** stage, heads[stage]
        for i in range(depth):
            n = f"{prefix}.stage{stage}_block{i}"
            shift = 0 if i % 2 == 0 else window // 2
            b, hh, ww, _ = y.shape
            pb, pr = (-hh) % window, (-ww) % window
            z = F.pad(layer_norm(P, f"{n}.norm1", y), (0, 0, 0, pr, 0, pb))
            hp, wp = hh + pb, ww + pr
            if shift:
                z = torch.roll(z, (-shift, -shift), (1, 2))
            wins = z.reshape(b, hp // window, window, wp // window, window, dim)
            wins = wins.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, dim)
            nw, l, _ = wins.shape
            qkv = dense(P, f"{n}.attn.qkv", wins).reshape(nw, l, 3, nh, dim // nh)
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            att = (q @ k.transpose(-2, -1)) * (dim // nh) ** -0.5
            bias = P[f"{n}.attn.rel_pos_bias"][_rel_index(window, y.device)]
            att = att + bias.reshape(l, l, nh).permute(2, 0, 1)[None]
            if shift:
                mask = _shift_mask(hp, wp, window, shift, y.device)
                g = mask.shape[0]
                att = (att.reshape(nw // g, g, nh, l, l) + mask[None, :, None]).reshape(nw, nh, l, l)
            out = (torch.softmax(att, -1) @ v).transpose(1, 2).reshape(nw, l, dim)
            out = dense(P, f"{n}.attn.proj", out)
            out = out.reshape(b, hp // window, wp // window, window, window, dim)
            out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, dim)
            if shift:
                out = torch.roll(out, (shift, shift), (1, 2))
            y = y + out[:, :hh, :ww]
            m = F.gelu(dense(P, f"{n}.mlp_fc1", layer_norm(P, f"{n}.norm2", y)), approximate="tanh")
            y = y + dense(P, f"{n}.mlp_fc2", m)
        if stage >= 1:
            outs.append(layer_norm(P, f"{prefix}.out_norm{stage}", y))
        if stage < len(depths) - 1:
            b, hh, ww, c = y.shape
            y = F.pad(y, (0, 0, 0, ww % 2, 0, hh % 2))
            hh, ww = hh + hh % 2, ww + ww % 2
            y = y.reshape(b, hh // 2, 2, ww // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            y = y.reshape(b, hh // 2, ww // 2, 4 * c)
            y = dense(P, f"{prefix}.merge_reduce{stage}", layer_norm(P, f"{prefix}.merge_norm{stage}", y))
    return outs


def backbone(P: Params, cfg: dict, images: Tensor) -> List[Tensor]:
    name = cfg["backbone"]
    if name == "resnet50":
        return resnet50(P, "backbone", images)
    if name.startswith("swin"):
        s = cfg["swin"]
        return swin(P, "backbone", images, s["embed_dim"], s["depths"], s["num_heads"],
                    s["window_size"])
    raise NotImplementedError(f"no reference backbone {name!r}")


# ---------------------------------------------------------------------------
# position embeddings, proposals
# ---------------------------------------------------------------------------
def _sincos(x: Tensor, temperature: float, feats: int) -> Tensor:
    dim_t = torch.arange(feats, dtype=torch.float32, device=x.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / feats)
    pos = x[..., None] / dim_t
    return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], -1).flatten(-2)


def sine_embedding(mask: Tensor, feats: int, t_h: float, t_w: float) -> Tensor:
    """DETR's normalised sine embedding of a padding mask -> [B, H, W, 2 feats]."""
    nm = (~mask).float()
    y = nm.cumsum(1)
    x = nm.cumsum(2)
    y = y / (y[:, -1:, :] + 1e-6) * 2 * math.pi
    x = x / (x[:, :, -1:] + 1e-6) * 2 * math.pi
    return torch.cat([_sincos(y, t_h, feats), _sincos(x, t_w, feats)], -1)


def query_sine(ref: Tensor, feats: int = 128) -> Tensor:
    """DINO's ``gen_sineembed_for_position`` of (cx, cy, w, h) -> (y, x, w, h) embeddings."""
    s = ref * 2 * math.pi
    e = [_sincos(s[..., i], 10000.0, feats) for i in range(4)]
    return torch.cat([e[1], e[0], e[2], e[3]], -1)


def resize_mask(mask: Tensor, hw: Tuple[int, int]) -> Tensor:
    """``F.interpolate(mode="nearest")`` of a bool mask."""
    return F.interpolate(mask[:, None].float(), size=hw, mode="nearest")[:, 0] > 0.5


def valid_ratio(mask: Tensor) -> Tensor:
    h, w = mask.shape[1:]
    return torch.stack([(~mask[:, 0, :]).sum(1).float() / w,
                        (~mask[:, :, 0]).sum(1).float() / h], -1)


def proposals(mask_flat: Tensor, shapes) -> Tuple[Tensor, Tensor]:
    """-> (proposals [B, S, 4] in logit space, valid [B, S])."""
    b = mask_flat.shape[0]
    out, cur = [], 0
    for lvl, (h, w) in enumerate(shapes):
        m = mask_flat[:, cur:cur + h * w].reshape(b, h, w)
        vh = (~m[:, :, 0]).sum(1).float()
        vw = (~m[:, 0, :]).sum(1).float()
        gy, gx = torch.meshgrid(torch.arange(h, device=m.device, dtype=torch.float32),
                                torch.arange(w, device=m.device, dtype=torch.float32),
                                indexing="ij")
        grid = (torch.stack([gx, gy], -1)[None] + 0.5) / torch.stack([vw, vh], -1)[:, None, None]
        wh = torch.full_like(grid, 0.05 * 2.0 ** lvl)
        out.append(torch.cat([grid, wh], -1).reshape(b, h * w, 4))
        cur += h * w
    p = torch.cat(out, 1)
    valid = ((p > 0.01) & (p < 0.99)).all(-1) & ~mask_flat
    logit = torch.log(p / (1 - p).clamp(min=1e-9))
    return logit.masked_fill(~valid[..., None], float("inf")), valid


# ---------------------------------------------------------------------------
# deformable attention
# ---------------------------------------------------------------------------
def msda_core(value: Tensor, shapes, loc: Tensor, aw: Tensor) -> Tensor:
    """value [B, S, M, D], loc [B, Q, M, L, P, 2] in [0, 1], aw [B, Q, M, L, P]
    -> [B, Q, M * D]: bilinear samples with zero padding, weighted and summed."""
    b, _, m, d = value.shape
    _, q, _, nl, p, _ = loc.shape
    levels = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    samples = []
    for lvl, (h, w) in enumerate(shapes):
        v = levels[lvl].flatten(2).transpose(1, 2).reshape(b * m, d, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)  # [B*M, Q, P, 2]
        samples.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))  # [B*M, D, Q, P]
    a = aw.transpose(1, 2).reshape(b * m, 1, q, nl * p)
    out = (torch.stack(samples, -2).flatten(-2) * a).sum(-1)  # [B*M, D, Q]
    return out.reshape(b, m * d, q).transpose(1, 2)


def msdeform_attn(P: Params, name: str, query: Tensor, ref: Tensor, value_src: Tensor, shapes,
                  pad: Optional[Tensor], heads: int = 8, levels: int = 4, points: int = 4,
                  clamp: Optional[float] = None) -> Tensor:
    """Deformable attention; ``clamp`` bounds the sampling offsets to +-clamp."""
    b, q, c = query.shape
    value = dense(P, f"{name}.value_proj", value_src)
    if pad is not None:
        value = value.masked_fill(pad[..., None], 0.0)
    value = value.reshape(b, -1, heads, c // heads)
    off = dense(P, f"{name}.sampling_offsets", query).reshape(b, q, heads, levels, points, 2)
    if clamp is not None:
        off = off.clamp(-clamp, clamp)
    aw = dense(P, f"{name}.attention_weights", query).reshape(b, q, heads, levels * points)
    aw = torch.softmax(aw, -1).reshape(b, q, heads, levels, points)
    if ref.shape[-1] == 2:
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=off.dtype, device=off.device)
        loc = ref[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
    else:
        r = ref[:, :, None, :, None, :]
        loc = r[..., :2] + off / points * r[..., 2:] * 0.5
    return dense(P, f"{name}.output_proj", msda_core(value, shapes, loc, aw))


def offset_clamp(cfg: dict, shapes) -> Optional[float]:
    """The configuration's bound on the encoder's sampling offsets: with a
    windowed ``msda_impl`` and ``msda_clamp_offsets``, +-(margin - 0.5) where
    one tile grid divides every level (each level's tile, the first level's
    scaled by the level's size, whole and at least 1); else none."""
    if cfg["msda_impl"] not in ("tiled", "pallas", "pallas2") or not cfg["msda_clamp_offsets"]:
        return None
    (h0, w0), (th, tw) = shapes[0], cfg["msda_tile"]
    for h, w in shapes:
        qh, qw = th * h / h0, tw * w / w0
        if qh < 1 or qw < 1 or qh != int(qh) or qw != int(qw):
            return None
    return cfg["msda_margin"] - 0.5


def ffn(P: Params, name: str, x: Tensor) -> Tensor:
    h = dense(P, f"{name}.linear2", torch.relu(dense(P, f"{name}.linear1", x)))
    return layer_norm(P, f"{name}.norm", x + h)


def mha(P: Params, name: str, q_in: Tensor, v_in: Tensor, heads: int,
        mask: Optional[Tensor] = None) -> Tensor:
    b, lq, d = q_in.shape
    hd = d // heads
    q = dense(P, f"{name}.query", q_in).reshape(b, lq, heads, hd) / math.sqrt(hd)
    k = dense(P, f"{name}.key", q_in).reshape(b, lq, heads, hd)
    v = dense(P, f"{name}.value", v_in).reshape(b, -1, heads, hd)
    w = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mask is not None:
        w = w.masked_fill(~mask[:, None], torch.finfo(w.dtype).min)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(w, -1), v).reshape(b, lq, d)
    return dense(P, f"{name}.out", out)


def clip_logits(P: Params, proj: str, h: Tensor, text: Tensor) -> Tensor:
    """The CLIP-text classifier: exp(logit_scale) cos(proj(h), text)."""
    v = l2n(F.linear(h, P[f"{proj}.weight"]))
    return torch.exp(P["logit_scale"]) * (v @ l2n(text).t())


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------
def encode_dn_labels(P: Params, labels: Tensor, text: Tensor, num_classes: int) -> Tensor:
    """CDN label -> content query: ``label_proj(text)`` at the label, zero at -1."""
    emb = F.linear(text, P["label_proj.weight"])[labels.clamp(0, num_classes - 1)]
    return torch.where((labels < 0)[..., None], torch.zeros_like(emb), emb)


def detector(P: Params, cfg: dict, images: Tensor, pad_mask: Tensor, text: Tensor,
             dn: Optional[Dict[str, Tensor]] = None, train: bool = False,
             candidates: int = 0) -> Dict[str, Tensor]:
    """The forward of the detector. With ``dn`` (``labels``, ``boxes_unsig``,
    ``attn_mask``) the CDN queries go first. -> ``pred_logits`` and
    ``pred_boxes`` of every decoder layer ``[Ld, B, Q, ...]`` (the matching
    queries; the CDN ones under ``dn_logits`` and ``dn_boxes``), the two-stage
    set ``interm_logits``, ``interm_boxes``, ``init_boxes``, and in training the
    final layer's ``clip_embed`` and ``clip_logits`` of every query. With
    ``candidates`` (more than ``num_queries``, no ``dn``), the decoder runs over
    the ``candidates`` best proposals, each of the ``num_queries`` best
    attending to those alone (so their outputs are the plain forward's) and
    each further one to them and itself, as it would if rounding had swapped
    it into the set; ``cand_logits`` and ``cand_boxes`` are all candidates'
    final-layer outputs. The further ones take ``tgt_embed``'s first row as
    their content query, as every rank has it where
    :func:`benchmark.harness.weights.make` repeats it over the rows."""
    hidden = cfg["hidden_dim"]
    feats = backbone(P, cfg, images)
    srcs = []
    for i in range(4):
        x = feats[i] if i < 3 else feats[-1]
        x = x.permute(0, 3, 1, 2)
        x = conv_nchw(P, f"input_proj{i}.conv", x, *((2, 1) if i == 3 else (1, 0)))
        x = F.group_norm(x, 32, P[f"input_proj{i}.norm.weight"], P[f"input_proj{i}.norm.bias"], 1e-5)
        srcs.append(x.permute(0, 2, 3, 1))
    masks = [resize_mask(pad_mask, s.shape[1:3]) for s in srcs]
    shapes = [tuple(s.shape[1:3]) for s in srcs]
    src = torch.cat([s.flatten(1, 2) for s in srcs], 1)
    mask = torch.cat([m.flatten(1) for m in masks], 1)
    pos = torch.cat([sine_embedding(m, hidden // 2, cfg["pe_temperatureH"], cfg["pe_temperatureW"])
                     .flatten(1, 2) + P["level_embed"][lvl] for lvl, m in enumerate(masks)], 1)
    vr = torch.stack([valid_ratio(m) for m in masks], 1)  # [B, L, (w, h)]

    grid = []
    for lvl, (h, w) in enumerate(shapes):
        ry, rx = torch.meshgrid(torch.linspace(0.5, h - 0.5, h, device=src.device),
                                torch.linspace(0.5, w - 0.5, w, device=src.device), indexing="ij")
        grid.append(torch.stack([rx.reshape(-1)[None] / (vr[:, None, lvl, 0] * w),
                                 ry.reshape(-1)[None] / (vr[:, None, lvl, 1] * h)], -1))
    enc_ref = torch.cat(grid, 1)[:, :, None] * vr[:, None]
    memory, bound = src, offset_clamp(cfg, shapes)
    for i in range(cfg["enc_layers"]):
        n = f"encoder_layer{i}"
        attn = msdeform_attn(P, f"{n}.self_attn", memory + pos, enc_ref, memory, shapes, mask,
                             cfg["nheads"], 4, cfg["enc_n_points"], bound)
        memory = ffn(P, f"{n}.ffn", layer_norm(P, f"{n}.norm1", memory + attn))

    props, pvalid = proposals(mask, shapes)
    out_mem = torch.where(pvalid[..., None], memory, torch.zeros_like(memory))
    out_mem = layer_norm(P, "enc_output_norm", dense(P, "enc_output", out_mem))
    with torch.no_grad():
        score = clip_logits(P, "enc_out_class_embed.dino_visual_proj", out_mem, text).amax(-1)
    score = score.masked_fill(~pvalid, float("-inf"))
    enc = {"memory": memory, "shapes": shapes, "mask": mask, "vr": vr, "out_mem": out_mem,
           "props": props, "score": score}
    nq = cfg["num_queries"]
    if not candidates:
        out = _decode(P, cfg, enc, text, nq, P["tgt_embed"], dn)
    else:
        j = torch.arange(candidates, device=src.device)
        seen = (j[None] < nq) | (j[None] == j[:, None])
        tgt = torch.cat([P["tgt_embed"], P["tgt_embed"][:1].expand(candidates - nq, -1)])
        out = _decode(P, cfg, enc, text, candidates, tgt,
                      seen=seen[None].expand(images.shape[0], -1, -1))
        out["cand_logits"], out["cand_boxes"] = out["pred_logits"][-1], out["pred_boxes"][-1]
        for key in ("pred_logits", "pred_boxes", "interm_logits", "interm_boxes", "init_boxes"):
            out[key] = out[key][..., :nq, :]
    hs_last = out.pop("hs_last")
    if train:
        emb = l2n(F.linear(hs_last, P["clip_visual_proj.weight"]))
        out["clip_embed"] = emb
        out["clip_logits"] = torch.exp(P["logit_scale"]) * (emb @ l2n(text).t())
    return out


def _decode(P: Params, cfg: dict, enc: Dict[str, Any], text: Tensor, nq: int, tgt_embed: Tensor,
            dn: Optional[Dict[str, Tensor]] = None, seen: Optional[Tensor] = None
            ) -> Dict[str, Tensor]:
    """Two-stage selection of the ``nq`` best proposals of the encoder's
    output ``enc``, then the decoder over them (content queries ``tgt_embed``
    ``[nq, D]``, the CDN queries first with ``dn``; ``seen [B, nq, nq]``, the
    keys each query's self-attention may see, without ``dn``)."""
    hidden, heads = cfg["hidden_dim"], cfg["nheads"]
    memory, shapes, mask, vr = enc["memory"], enc["shapes"], enc["mask"], enc["vr"]
    b = memory.shape[0]
    idx = torch.topk(enc["score"], nq, dim=1).indices

    def take(x):
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    tgt_undetach = take(enc["out_mem"])
    props_sel = take(enc["props"])
    ref_undetach = mlp(P, "enc_out_bbox_embed", tgt_undetach, 3) + props_sel
    ref_unsig = ref_undetach.detach()
    tgt = tgt_embed[None].expand(b, -1, -1)
    num_dn, attn_mask = 0, seen
    if dn is not None:
        num_dn = dn["labels"].shape[1]
        tgt = torch.cat([encode_dn_labels(P, dn["labels"], text, cfg["num_classes"]), tgt], 1)
        ref_unsig = torch.cat([dn["boxes_unsig"], ref_unsig], 1)
        attn_mask = dn["attn_mask"]

    ref = torch.sigmoid(ref_unsig)
    vr4 = torch.cat([vr, vr], -1)[:, None]
    refs, hs = [ref], []  # each layer's input boxes, the later ones not detached
    for i in range(cfg["dec_layers"]):
        n = f"decoder_layer{i}"
        ref_in = ref[:, :, None] * vr4
        qpos = mlp(P, "ref_point_head", query_sine(ref_in[:, :, 0], hidden // 2), 2)
        qk = tgt + qpos
        tgt = layer_norm(P, f"{n}.norm2", tgt + mha(P, f"{n}.self_attn", qk, tgt, heads, attn_mask))
        ca = msdeform_attn(P, f"{n}.cross_attn", tgt + qpos, ref_in, memory, shapes, mask,
                           heads, 4, cfg["dec_n_points"])
        tgt = ffn(P, f"{n}.ffn", layer_norm(P, f"{n}.norm1", tgt + ca))
        refs.append(torch.sigmoid(mlp(P, "bbox_embed", tgt, 3) + inverse_sigmoid(ref)))
        ref = refs[-1].detach()
        hs.append(tgt)
    hs = layer_norm(P, "decoder_norm", torch.stack(hs))
    boxes = torch.sigmoid(mlp(P, "bbox_embed", hs, 3) + inverse_sigmoid(torch.stack(refs[:-1])))
    logits = clip_logits(P, "class_embed.dino_visual_proj", hs, text)
    out = {"pred_logits": logits[:, :, num_dn:], "pred_boxes": boxes[:, :, num_dn:],
           "interm_logits": clip_logits(P, "enc_out_class_embed.dino_visual_proj", tgt_undetach, text),
           "interm_boxes": torch.sigmoid(ref_undetach),
           "init_boxes": torch.sigmoid(props_sel), "hs_last": hs[-1]}
    if num_dn:
        out["dn_logits"], out["dn_boxes"] = logits[:, :, :num_dn], boxes[:, :, :num_dn]
    return out


def postprocess(logits: Tensor, boxes: Tensor, orig_size: Tensor, num_select: int
                ) -> Dict[str, Tensor]:
    """Flat top-``num_select`` of sigmoid scores over (query, class) -> scores,
    labels, xyxy boxes in the original image's pixels, and each entry's query."""
    b, q, c = logits.shape
    scores, idx = torch.topk(torch.sigmoid(logits).reshape(b, q * c), num_select, dim=1)
    query = torch.div(idx, c, rounding_mode="floor")
    xyxy = torch.gather(cxcywh_to_xyxy(boxes), 1, query[..., None].expand(-1, -1, 4))
    h, w = orig_size[:, 0].float(), orig_size[:, 1].float()
    xyxy = xyxy * torch.stack([w, h, w, h], -1)[:, None]
    return {"scores": scores, "labels": idx % c, "boxes": xyxy, "query": query}


def eval_forward(P: Params, cfg: dict, batch: Dict[str, Tensor], text: Tensor) -> Dict[str, Tensor]:
    """The eval step: the forward, then :func:`postprocess` of the final layer."""
    out = detector(P, cfg, batch["images"], batch["pad_mask"], text)
    return postprocess(out["pred_logits"][-1], out["pred_boxes"][-1], batch["orig_size"],
                       cfg["num_select"])
