"""DINO deformable-DETR detector (counterpart of ``richsem_tpu/models/dino.py``).

Backbone (ResNet-50/101, Swin, ConvNeXt or FocalNet, :func:`build_backbone`)
-> 4-level input projections -> deformable encoder (K1 sampler,
K2 tail) -> two-stage top-``num_queries`` selection -> decoder with iterative
box refinement (K1 cross-attention) -> stacked shared heads and, with
``use_language``, the CLIP-text dot-product classifier. Module and parameter
names follow the flax tree (``encoder_layer0.self_attn.value_proj``,
``input_proj3.conv``, ``backbone.layer2_block0.conv2``,
``decoder_layer5.self_attn.query``), so :mod:`richsem_tpu_torch.utils.convert`
only reshapes and transposes.

Precision: matmul-heavy submodules run in ``compute_dtype`` at exactly the
sites where flax has ``dtype=compute_dtype``; norms, attention-weight
softmaxes, sampling locations, box arithmetic and the class-logit
accumulation stay float32.

Training (``train=True``) takes the contrastive-denoising queries of
:mod:`richsem_tpu_torch.models.dn` and puts ``.detach()`` at exactly the JAX
package's ``stop_gradient`` sites: the two-stage selection scores, the
reference points handed to the decoder, the content queries when
``embed_init_tgt`` is off, the reference between decoder layers (the list of
references keeps the undetached boxes) and the offset-saturation monitor.
Dropout (``dropout > 0``) acts in training only, drawn from the generator the
caller passes (``dropout_generator``): after each sampler, in the decoder's
self-attention weights and in every FFN; the encoder then runs the flax-module
tail (LN1, FFN, LN2) in place of K2, as it does for an activation other than
relu.

RichSem's semantic-branch knobs follow the JAX package: ``share_vl_proj`` (one
4-layer MLP, ``vl_proj``, projects for the classifier and for distillation),
``enc_cls_agn`` (a linear encoder head), ``two_stage_cls`` (in training the
detached CLIP class probabilities join every decoder layer's logits),
``distill_aux_layers`` (CLIP outputs of every decoder layer) and
``use_clip_visual_query`` (the decoder's content queries are projected 1x1
RoIs of the teacher's spatial map, ``clip_features``, at the reference boxes).

The memory knobs act where a gradient is taken, as the JAX package's
``nn.remat`` does, and change no number: ``backbone_remat`` recomputes the
ResNet in the backward (the JAX package remats no other backbone);
``use_checkpoint`` recomputes every encoder and decoder layer, keeping the
products' outputs (K1 and K2 run again); ``enc_selective_remat`` (without
``use_checkpoint``) recomputes every encoder layer but keeps the output of
its K1 call, which does not run again.

With ``masks=True`` the detector carries a mask head on the final layer's
matching queries: DETRsegm (``mask_head_type="detr"``: ``mask_attention``
over the stride-32 projection, ``mask_head`` up through strides 16 and 8,
``pred_masks [B, nq, H/8, W/8]``) or CondInst (``"cond_inst"``:
``mask_feats`` from the first three projections, the controller's
``mask_params`` a query, and the dynamic networks' layout). The heads compute
in f32, as their flax modules (no ``dtype=``) do. A caller that reads no mask
output (the eval step) passes ``mask_head=False``, and the head does not run,
as XLA drops it from JAX's eval step.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from richsem_tpu_torch.models.layers import (
    FFN,
    MLP,
    Dense,
    InputProj,
    LayerNorm,
    MSDeformAttn,
    MultiHeadAttention,
    dropout,
    normal_,
)
from richsem_tpu_torch.models.cond_inst import CondInstHead
from richsem_tpu_torch.models.convnext import ConvNeXt, ConvNeXtConfig
from richsem_tpu_torch.models.focalnet import FocalNet, FocalNetConfig
from richsem_tpu_torch.models.resnet import ResNet
from richsem_tpu_torch.models.segmentation import MaskHeadSmallConv, MHAttentionMap
from richsem_tpu_torch.models.swin import SwinConfig, SwinTransformer
from richsem_tpu_torch.models.transformer_utils import (
    encoder_reference_points,
    flatten_levels,
    gen_encoder_output_proposals,
)
from richsem_tpu_torch.ops.fused_ffn import encoder_tail
from richsem_tpu_torch.ops.position_encoding import (
    gen_sineembed_for_position,
    sine_position_embedding,
)
from richsem_tpu_torch.utils.misc import (
    inverse_sigmoid,
    l2_normalize,
    resize_mask,
    valid_ratios,
)
from richsem_tpu_torch.ops.roi_align import roi_align
from richsem_tpu_torch.utils.boxes import box_cxcywh_to_xyxy

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DINOConfig:
    """Static architecture knobs; the same fields and defaults as the JAX ``DINOConfig``."""

    num_classes: int = 1204
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.0
    activation: str = "relu"
    num_queries: int = 900
    num_feature_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4
    backbone: str = "resnet50"
    return_strides: Tuple[int, ...] = (8, 16, 32)
    pe_temperature_h: float = 20.0
    pe_temperature_w: float = 20.0
    two_stage_type: str = "standard"
    embed_init_tgt: bool = True
    use_language: bool = False
    clip_embed_dim: int = 1024
    use_cls_mlp_proj: bool = True
    use_mlp_proj: bool = False
    use_visual_distill: bool = False
    two_stage_cls: bool = False
    distill_aux_layers: bool = False
    use_clip_visual_query: bool = False
    share_vl_proj: bool = False
    enc_cls_agn: bool = False
    dn_labelbook_size: int = 1204
    dn_labelbook_reuse_cls: bool = True
    compute_dtype: Any = torch.float32
    # memory knobs of the training step (``remat``); they change no number, and
    # act only where a gradient is taken
    use_checkpoint: bool = False
    enc_selective_remat: bool = False
    backbone_remat: bool = False
    # On CUDA the encoder tail is always K2. The impl knobs below decide the
    # offset clamp and the sampler, as in JAX (models/layers.py): "sep_pallas"
    # runs the separable sampler K3, every other impl the exact gather K1.
    enc_fused_tail: bool = True
    msda_impl: str = "gather"
    dec_msda_impl: str = "sep"
    msda_margin: int = 8
    msda_tile: Tuple[int, int] = (16, 16)
    msda_clamp_offsets: bool = True
    masks: bool = False
    mask_head_type: str = "detr"

    @classmethod
    def from_config(cls, cfg) -> "DINOConfig":
        """Same mapping, and the same refusals, as the JAX ``DINOConfig.from_config``."""
        compute_dtype = _DTYPES[getattr(cfg, "compute_dtype", "float32")]
        _unsupported = {
            "num_patterns": lambda v: v not in (0, None),
            "dec_layer_number": lambda v: v is not None,
            "decoder_sa_type": lambda v: v not in ("sa", None),
            "two_stage_keep_all_tokens": bool,
            "two_stage_learn_wh": bool,
            "two_stage_pat_embed": lambda v: v not in (0, None),
            "two_stage_add_query_num": lambda v: v not in (0, None),
            "random_refpoints_xy": bool,
            "decoder_layer_noise": bool,
        }
        for key, is_set in _unsupported.items():
            if key in cfg and is_set(cfg[key]):
                raise NotImplementedError(
                    f"config knob {key!r}={cfg[key]!r} is not implemented "
                    "(rare reference variant; see PARITY.md)"
                )
        if getattr(cfg, "use_clip_visual_query", False) and not cfg.use_language:
            raise NotImplementedError("use_clip_visual_query requires use_language=True")
        if getattr(cfg, "use_clip_visual_query", False) and not cfg.use_visual_distill:
            raise NotImplementedError(
                "use_clip_visual_query requires use_visual_distill=True "
                "(the teacher spatial map is computed on the distill path)"
            )
        return cls(
            num_classes=cfg.num_classes,
            hidden_dim=cfg.hidden_dim,
            nheads=cfg.nheads,
            enc_layers=cfg.enc_layers,
            dec_layers=cfg.dec_layers,
            dim_feedforward=cfg.dim_feedforward,
            dropout=cfg.dropout,
            activation=cfg.transformer_activation,
            num_queries=cfg.num_queries,
            num_feature_levels=cfg.num_feature_levels,
            enc_n_points=cfg.enc_n_points,
            dec_n_points=cfg.dec_n_points,
            backbone=cfg.backbone,
            pe_temperature_h=cfg.pe_temperatureH,
            pe_temperature_w=cfg.pe_temperatureW,
            two_stage_type=cfg.two_stage_type,
            embed_init_tgt=cfg.embed_init_tgt,
            use_language=cfg.use_language,
            use_cls_mlp_proj=cfg.use_cls_mlp_proj,
            use_mlp_proj=cfg.use_mlp_proj,
            use_visual_distill=cfg.use_visual_distill,
            two_stage_cls=bool(getattr(cfg, "two_stage_cls", False)
                               and cfg.use_visual_distill),
            distill_aux_layers=getattr(cfg, "distill_aux_layers", False),
            clip_embed_dim=getattr(
                cfg, "clip_embed_dim",
                512 if getattr(cfg, "clip_model", "RN50") == "ViT-B/32" else 1024,
            ),
            use_clip_visual_query=getattr(cfg, "use_clip_visual_query", False),
            share_vl_proj=getattr(cfg, "share_vl_proj", False),
            enc_cls_agn=getattr(cfg, "enc_cls_agn", False),
            dn_labelbook_size=cfg.dn_labelbook_size,
            dn_labelbook_reuse_cls=cfg.dn_labelbook_reuse_cls,
            compute_dtype=compute_dtype,
            use_checkpoint=getattr(cfg, "use_checkpoint", False),
            enc_selective_remat=getattr(cfg, "enc_selective_remat", False),
            backbone_remat=getattr(cfg, "backbone_remat", False),
            enc_fused_tail=getattr(cfg, "enc_fused_tail", True),
            msda_impl=getattr(cfg, "msda_impl", "gather"),
            dec_msda_impl=getattr(cfg, "dec_msda_impl", "sep"),
            msda_margin=getattr(cfg, "msda_margin", 8),
            msda_tile=tuple(getattr(cfg, "msda_tile", (16, 16))),
            msda_clamp_offsets=getattr(cfg, "msda_clamp_offsets", True),
            masks=getattr(cfg, "masks", False),
            mask_head_type=getattr(cfg, "mask_head_type", "detr"),
        )


_CLS_BIAS = -math.log((1 - 0.01) / 0.01)  # focal prior


def build_backbone(c: DINOConfig, device) -> Tuple[nn.Module, Tuple[int, ...]]:
    """-> (backbone, its output channels), chosen by name as the JAX ``DINO.setup``
    chooses (``richsem_tpu/models/dino.py:413-463``): ResNet-50/101, Swin,
    ConvNeXt or FocalNet, the last three from their variant tables (an unknown
    variant raises their ``KeyError``) in ``compute_dtype``; any other name
    raises ``NotImplementedError``."""
    if c.backbone in ("resnet50", "resnet101"):
        blocks = (3, 4, 6, 3) if c.backbone == "resnet50" else (3, 4, 23, 3)
        return (ResNet(blocks, c.return_strides, dtype=c.compute_dtype, device=device),
                ResNet.out_channels(c.return_strides))
    families = (("swin", SwinConfig, SwinTransformer), ("convnext", ConvNeXtConfig, ConvNeXt),
                ("focalnet", FocalNetConfig, FocalNet))
    for prefix, cfg_cls, cls in families:
        if c.backbone.startswith(prefix):
            bcfg = dataclasses.replace(cfg_cls.variant(c.backbone), dtype=c.compute_dtype)
            return cls(bcfg, device=device), bcfg.num_channels()
    raise NotImplementedError(c.backbone)


# The memory knobs (``dino.py:416-420``, :474-503 of the JAX package). Each
# recomputes part of the forward in the backward with torch.utils.checkpoint
# (non-reentrant, no RNG state: nothing in these regions draws); the numbers
# do not change. ``dots_saveable``'s counterpart keeps every product's output;
# ``save_only_these_names("msda_out")``'s keeps the encoder's deformable
# sampler output, the dispatcher op ``msda_out`` (``ops/ms_deform_attn.py``).
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
        torch.ops.aten.bmm.default)
MSDA_OUT = (torch.ops.richsem_tpu_torch.msda_out.default,)


def remat(fn, *args, saved: Optional[Sequence] = None):
    """``fn(*args)`` under ``torch.utils.checkpoint``: the outputs of the ops in
    ``saved`` are kept, every other tensor the backward needs is recomputed;
    ``saved`` None recomputes everything."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if saved is not None:
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             list(saved))
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


class DeformableEncoderLayer(nn.Module):
    """Deformable self-attention (K1) -> residual+LN1 -> FFN -> residual+LN2 (K2).

    With an activation other than relu, or dropout in training (a
    ``generator``), the tail is the modules' composition, as JAX's knob
    variants keep flax's modules (``dino.py:293-301``): K2 does not run.
    Neither does it with ``enc_fused_tail=False``, which runs the same
    composition, the function of JAX's ``xla_encoder_tail``
    (``dino.py:316-320``)."""

    def __init__(self, c: DINOConfig, device=None):
        super().__init__()
        self.compute_dtype = c.compute_dtype
        self.activation, self.dropout = c.activation, c.dropout
        self.fused_tail = c.enc_fused_tail
        self.self_attn = MSDeformAttn(
            d_model=c.hidden_dim, n_levels=c.num_feature_levels, n_heads=c.nheads,
            n_points=c.enc_n_points, compute_dtype=c.compute_dtype, impl=c.msda_impl,
            tiled_margin=c.msda_margin, tiled_tile=c.msda_tile,
            clamp_offsets=c.msda_clamp_offsets, device=device,
        )
        self.norm1 = LayerNorm(c.hidden_dim, device=device)
        self.ffn = FFN(c.hidden_dim, c.dim_feedforward, c.activation, c.compute_dtype,
                       device=device, dropout_rate=c.dropout)

    def forward(self, src, pos, reference_points, spatial_shapes, pad_mask,
                monitor=None, generator=None):
        attn_out = self.self_attn(src + pos, reference_points, src, spatial_shapes,
                                  pad_mask, monitor=monitor)
        if self.activation != "relu" or generator is not None or not self.fused_tail:
            attn_out = dropout(attn_out, self.dropout, generator)
            return self.ffn(self.norm1(src + attn_out), generator)
        b, s, d = src.shape
        ffn = self.ffn
        y = encoder_tail(
            src.float().reshape(b * s, d), attn_out.float().reshape(b * s, d),
            ffn.linear1.weight, ffn.linear1.bias, ffn.linear2.weight, ffn.linear2.bias,
            self.norm1.weight, self.norm1.bias, ffn.norm.weight, ffn.norm.bias,
            1e-5, self.compute_dtype,
        )
        return y.reshape(b, s, d)

    def init_weights(self, g: torch.Generator) -> None:
        self.self_attn.init_weights(g)
        self.norm1.init_weights(g)
        self.ffn.init_weights(g)


class DeformableDecoderLayer(nn.Module):
    """self-attn -> deformable cross-attn (K1, no clamp) -> FFN."""

    def __init__(self, c: DINOConfig, device=None):
        super().__init__()
        self.dropout = c.dropout
        self.self_attn = MultiHeadAttention(c.hidden_dim, c.nheads, c.compute_dtype,
                                            device=device, dropout_rate=c.dropout)
        self.norm2 = LayerNorm(c.hidden_dim, device=device)
        self.cross_attn = MSDeformAttn(
            d_model=c.hidden_dim, n_levels=c.num_feature_levels, n_heads=c.nheads,
            n_points=c.dec_n_points, compute_dtype=c.compute_dtype,
            impl=c.dec_msda_impl, device=device,
        )
        self.norm1 = LayerNorm(c.hidden_dim, device=device)
        self.ffn = FFN(c.hidden_dim, c.dim_feedforward, c.activation, c.compute_dtype,
                       device=device, dropout_rate=c.dropout)

    def forward(self, tgt, query_pos, reference_points_input, memory, spatial_shapes,
                memory_pad_mask, self_attn_mask=None, generator=None):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt, mask=self_attn_mask,
                                              generator=generator))
        ca = self.cross_attn(tgt + query_pos, reference_points_input, memory,
                             spatial_shapes, memory_pad_mask)
        tgt = self.norm1(tgt + dropout(ca, self.dropout, generator))
        return self.ffn(tgt, generator)

    def init_weights(self, g: torch.Generator) -> None:
        for mod in (self.self_attn, self.norm2, self.cross_attn, self.norm1, self.ffn):
            mod.init_weights(g)


def _clip_proj(c: DINOConfig, use_mlp: bool, device) -> nn.Module:
    if use_mlp:
        return MLP(c.hidden_dim, c.hidden_dim, c.clip_embed_dim, 4, device=device)
    return Dense(c.hidden_dim, c.clip_embed_dim, bias=False, device=device)


def _init_clip_proj(proj: nn.Module, ld: int, g: torch.Generator) -> None:
    """Last layer ~ N(0, ld^-1/2), zero bias; earlier MLP layers lecun."""
    last = proj.layers()[-1] if isinstance(proj, MLP) else proj
    if isinstance(proj, MLP):
        proj.init_weights(g)
    normal_(last.weight, g, ld**-0.5)
    if last.bias is not None:
        nn.init.zeros_(last.bias)


def head_product_plain(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``v [..., D] @ t [C, D]^T`` in f32: the plain version of :func:`head_product`."""
    return v.float() @ t.float().t()


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` with an f32 result: on the card one product of the
    operands' own dtype accumulated in f32 (``aten::mm.dtype``); on the CPU,
    which has no kernel for it, the product of their f32 copies."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _HeadProduct(torch.autograd.Function):
    """bf16 ``v @ t^T`` on the tensor cores with f32 accumulation and f32 output,
    as JAX's ``dot_general(..., preferred_element_type=f32)``. ``aten::mm.dtype``
    has no derivative, so the backward is written out as JAX's VJP of that dot
    (``_dot_general_transpose_lhs``): the f32 cotangent times the other operand
    in f32, rounded to the operand's dtype."""

    @staticmethod
    def forward(ctx, v, t):
        ctx.save_for_backward(v, t)
        out = _mm_f32(v.reshape(-1, v.shape[-1]), t.t())
        return out.reshape(*v.shape[:-1], t.shape[0])

    @staticmethod
    def backward(ctx, g):
        v, t = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        dv = dt = None
        if ctx.needs_input_grad[0]:
            dv = (g @ t.float()).to(v.dtype).reshape(v.shape)
        if ctx.needs_input_grad[1]:
            dt = (g.t() @ v.reshape(-1, v.shape[-1]).float()).to(t.dtype)
        return dv, dt


def head_product(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The CLIP-align head's ``v [..., D] @ t [C, D]^T`` from operands in
    ``compute_dtype``, accumulated in f32 and returned in f32. bf16 operands on
    the card go to the tensor cores (:class:`_HeadProduct`); every other case
    (CPU tensors, f32) runs :func:`head_product_plain`. The values agree: a
    product of two bf16 values is exact in f32, only the order of the sums
    differs."""
    if v.is_cuda and v.dtype == torch.bfloat16:
        return _HeadProduct.apply(v, t)
    return head_product_plain(v, t)


class ClipAlignHead(nn.Module):
    """Open-vocab classifier: CLIP text dot product (``CLIPAlign.forward_hs``).

    Projects queries into the CLIP joint space (``dino_visual_proj``, or with
    ``shared`` the ``proj`` the caller passes: ``share_vl_proj``'s ``vl_proj``,
    which holds the parameters), L2-normalizes both sides in f32, rounds both
    to ``compute_dtype`` and accumulates their product in f32
    (:func:`head_product`), then scales by exp(logit_scale).
    """

    def __init__(self, c: DINOConfig, use_mlp: bool = False, device=None, shared: bool = False):
        super().__init__()
        self.compute_dtype = c.compute_dtype
        self.embed_dim = c.clip_embed_dim
        self.dino_visual_proj = None if shared else _clip_proj(c, use_mlp, device)

    def forward(self, hs, text_embed, logit_scale, proj=None):
        v = l2_normalize((self.dino_visual_proj if proj is None else proj)(hs).float())
        t = l2_normalize(text_embed.float())
        cd = self.compute_dtype
        return torch.exp(logit_scale) * head_product(v.to(cd), t.to(cd))

    def init_weights(self, g: torch.Generator) -> None:
        if self.dino_visual_proj is not None:
            _init_clip_proj(self.dino_visual_proj, self.embed_dim, g)


class DINO(nn.Module):
    """The detector. Build with ``DINO(cfg, device)``, then ``init_weights(generator)``
    or load a converted state dict (:func:`richsem_tpu_torch.utils.convert.params_from_jax`).
    ``clip_spatial_dim`` is the width of the teacher's spatial map, the input of
    ``use_clip_visual_query``'s projection (2048 for RN50), which flax infers
    from its first call."""

    def __init__(self, cfg: DINOConfig, device="cuda", clip_spatial_dim: int = 2048):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DINO builds on 'cuda' unless asked otherwise, and no CUDA device "
                "is available; pass device='cpu' to build on the CPU"
            )
        c = self.cfg = cfg
        if c.two_stage_type != "standard":
            raise NotImplementedError(c.two_stage_type)
        self.backbone, chans = build_backbone(c, device)
        n_backbone = len(chans)
        for i in range(c.num_feature_levels):
            in_ch = chans[i] if i < n_backbone else (
                chans[-1] if i == n_backbone else c.hidden_dim)
            self.add_module(f"input_proj{i}", InputProj(
                in_ch, c.hidden_dim, extra_level=i >= n_backbone,
                dtype=c.compute_dtype, device=device,
            ))
        self.level_embed = nn.Parameter(
            torch.empty(c.num_feature_levels, c.hidden_dim, device=device))
        for i in range(c.enc_layers):
            self.add_module(f"encoder_layer{i}", DeformableEncoderLayer(c, device))
        for i in range(c.dec_layers):
            self.add_module(f"decoder_layer{i}", DeformableDecoderLayer(c, device))
        self.decoder_norm = LayerNorm(c.hidden_dim, device=device)
        self.enc_output = Dense(c.hidden_dim, c.hidden_dim, device=device)
        self.enc_output_norm = LayerNorm(c.hidden_dim, device=device)
        self.tgt_embed = nn.Parameter(
            torch.empty(c.num_queries, c.hidden_dim, device=device))
        self.ref_point_head = MLP(2 * c.hidden_dim, c.hidden_dim, c.hidden_dim, 2,
                                  device=device)
        self.bbox_embed = MLP(c.hidden_dim, c.hidden_dim, 4, 3, device=device)
        self.enc_out_bbox_embed = MLP(c.hidden_dim, c.hidden_dim, 4, 3, device=device)
        self.vl_proj = None
        if c.share_vl_proj and (c.use_language or c.use_visual_distill):
            # one MLP projects for the classifier and for distillation
            self.vl_proj = _clip_proj(c, True, device)
        if c.use_language:
            self.class_embed = ClipAlignHead(
                c, use_mlp=c.use_cls_mlp_proj and c.use_mlp_proj, device=device,
                shared=self.vl_proj is not None)
            if c.enc_cls_agn:  # a linear, class-agnostic encoder head
                self.enc_cls_kernel = nn.Parameter(
                    torch.empty((c.hidden_dim, c.num_classes), device=device))
                self.enc_cls_bias = nn.Parameter(torch.empty(c.num_classes, device=device))
            else:
                self.enc_out_class_embed = ClipAlignHead(c, use_mlp=False, device=device)
        if c.use_language or c.use_visual_distill:
            self.logit_scale = nn.Parameter(torch.empty((), device=device))
        else:
            shape = (c.hidden_dim, c.num_classes)
            self.cls_kernel = nn.Parameter(torch.empty(shape, device=device))
            self.cls_bias = nn.Parameter(torch.empty(c.num_classes, device=device))
            self.enc_cls_kernel = nn.Parameter(torch.empty(shape, device=device))
            self.enc_cls_bias = nn.Parameter(torch.empty(c.num_classes, device=device))
        if not c.dn_labelbook_reuse_cls:
            self.label_enc = nn.Parameter(
                torch.empty(c.dn_labelbook_size + 1, c.hidden_dim, device=device))
        elif c.use_language:
            self.label_proj = Dense(c.clip_embed_dim, c.hidden_dim, bias=False,
                                    device=device)
        if c.use_visual_distill and self.vl_proj is None:
            self.clip_visual_proj = _clip_proj(c, c.use_mlp_proj, device)
        if c.use_clip_visual_query:
            self.clip_query_proj = Dense(clip_spatial_dim, c.hidden_dim, bias=False,
                                         device=device)
        if c.masks and c.mask_head_type == "cond_inst":
            self.cond_inst = CondInstHead(c.hidden_dim, device=device)
        elif c.masks:  # DETRsegm
            self.mask_attention = MHAttentionMap(c.hidden_dim, c.nheads, device=device)
            self.mask_head = MaskHeadSmallConv(c.hidden_dim, c.nheads, device=device)

    def distill_proj(self) -> nn.Module:
        """The distillation projection: ``vl_proj`` under ``share_vl_proj``."""
        return self.vl_proj if self.vl_proj is not None else self.clip_visual_proj

    def layers(self, kind: str):
        n = self.cfg.enc_layers if kind == "encoder" else self.cfg.dec_layers
        return [getattr(self, f"{kind}_layer{i}") for i in range(n)]

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        """Random weights from ``g``, following the flax initializers."""
        c = self.cfg
        self.backbone.init_weights(g)
        for i in range(c.num_feature_levels):
            getattr(self, f"input_proj{i}").init_weights(g)
        normal_(self.level_embed, g, 1.0)
        for layer in self.layers("encoder") + self.layers("decoder"):
            layer.init_weights(g)
        for mod in (self.decoder_norm, self.enc_output, self.enc_output_norm,
                    self.ref_point_head):
            mod.init_weights(g)
        normal_(self.tgt_embed, g, 1.0)
        for head in (self.bbox_embed, self.enc_out_bbox_embed):
            head.init_weights(g)
            nn.init.zeros_(head.layers()[-1].weight)
            nn.init.zeros_(head.layers()[-1].bias)
        if self.vl_proj is not None:
            _init_clip_proj(self.vl_proj, c.clip_embed_dim, g)
        if c.use_language:
            self.class_embed.init_weights(g)
            if c.enc_cls_agn:
                normal_(self.enc_cls_kernel, g, c.hidden_dim**-0.5)
                self.enc_cls_bias.fill_(_CLS_BIAS)
            else:
                self.enc_out_class_embed.init_weights(g)
        if c.use_language or c.use_visual_distill:
            self.logit_scale.fill_(math.log(1 / 0.07))
        else:
            for k, b in ((self.cls_kernel, self.cls_bias),
                         (self.enc_cls_kernel, self.enc_cls_bias)):
                normal_(k, g, c.hidden_dim**-0.5)
                b.fill_(_CLS_BIAS)
        if not c.dn_labelbook_reuse_cls:
            normal_(self.label_enc, g, 1.0)
        elif c.use_language:
            normal_(self.label_proj.weight, g, c.clip_embed_dim**-0.5)
        if c.use_visual_distill and self.vl_proj is None:
            _init_clip_proj(self.clip_visual_proj, c.clip_embed_dim, g)
        if c.use_clip_visual_query:
            self.clip_query_proj.init_weights(g)
        if c.masks and c.mask_head_type == "cond_inst":
            self.cond_inst.init_weights(g)
        elif c.masks:
            self.mask_attention.init_weights(g)
            self.mask_head.init_weights(g)

    def _class_logits(self, h, text_embed, enc: bool = False):
        c = self.cfg
        if c.use_language and not (enc and c.enc_cls_agn):
            if enc:
                return self.enc_out_class_embed(h, text_embed, self.logit_scale)
            return self.class_embed(h, text_embed, self.logit_scale, proj=self.vl_proj)
        k = self.enc_cls_kernel if enc else self.cls_kernel
        bias = self.enc_cls_bias if enc else self.cls_bias
        return h.float() @ k + bias

    def encode_dn_labels(self, labels: torch.Tensor,
                         text_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DN label -> content embedding (``dino.py:643-664``): a label table, the
        closed-vocabulary classifier's rows, or ``label_proj(text_embed)``; -1
        slots get zero content."""
        c = self.cfg
        safe = labels.clamp(min=0)
        if not c.dn_labelbook_reuse_cls:
            emb = self.label_enc[safe.clamp(max=c.dn_labelbook_size)]
        elif c.use_language:
            emb = self.label_proj(text_embed)[safe.clamp(max=c.num_classes - 1)]
        else:
            emb = self.cls_kernel.t()[safe.clamp(max=c.num_classes - 1)]
        return torch.where((labels < 0)[..., None], emb.new_zeros(()), emb)

    def forward(
        self,
        images: torch.Tensor,  # [B, H, W, 3] normalized
        pad_mask: torch.Tensor,  # [B, H, W] True on padding
        dn_labels: Optional[torch.Tensor] = None,
        dn_boxes_unsig: Optional[torch.Tensor] = None,
        dn_attn_mask: Optional[torch.Tensor] = None,
        text_embed: Optional[torch.Tensor] = None,  # [C, clip_embed_dim]
        clip_features: Optional[torch.Tensor] = None,
        train: bool = False,
        dropout_generator: Optional[torch.Generator] = None,
        mask_head: bool = True,
    ) -> Dict[str, Any]:
        c = self.cfg
        images = images.to(c.compute_dtype)
        if c.backbone_remat and isinstance(self.backbone, ResNet) and torch.is_grad_enabled():
            feats = remat(self.backbone, images)  # the JAX package remats the ResNet only
        else:
            feats = self.backbone(images)
        return self.detect(feats, pad_mask, dn_labels=dn_labels,
                           dn_boxes_unsig=dn_boxes_unsig, dn_attn_mask=dn_attn_mask,
                           text_embed=text_embed, clip_features=clip_features,
                           train=train, dropout_generator=dropout_generator,
                           mask_head=mask_head)

    def detect(
        self,
        feats: Sequence[torch.Tensor],  # backbone maps [B, H/s, W/s, C_s]
        pad_mask: torch.Tensor,
        dn_labels: Optional[torch.Tensor] = None,
        dn_boxes_unsig: Optional[torch.Tensor] = None,
        dn_attn_mask: Optional[torch.Tensor] = None,
        text_embed: Optional[torch.Tensor] = None,
        clip_features: Optional[torch.Tensor] = None,
        train: bool = False,
        dropout_generator: Optional[torch.Generator] = None,
        mask_head: bool = True,
    ) -> Dict[str, Any]:
        """Input projections -> transformer -> heads, from backbone features.

        With ``train`` the output also holds ``offset_beyond_margin`` (where the
        encoder's windowed-kernel rule applies), and with DN inputs the DN
        queries' outputs under ``dn_outputs``. Dropout in training draws its
        masks from ``dropout_generator``. ``clip_features`` (the teacher's
        spatial map ``[B, h, w, Dv]``) feeds the content queries under
        ``use_clip_visual_query``. With ``masks`` the mask head's outputs join
        unless ``mask_head`` is False."""
        c = self.cfg
        if (dn_labels is None) != (dn_boxes_unsig is None):
            raise ValueError("dn_labels and dn_boxes_unsig come together")
        gen = None
        if train and c.dropout > 0.0:
            if dropout_generator is None:
                raise ValueError("dropout in training draws its masks from a generator: pass "
                                 "dropout_generator")
            if c.use_checkpoint or c.enc_selective_remat:
                raise ValueError("dropout in training and use_checkpoint or enc_selective_remat: "
                                 "a recomputed layer would draw other masks")
            gen = dropout_generator
        b = pad_mask.shape[0]

        # ---- projections (the extra level comes from feats[-1]) --------
        projs = [getattr(self, f"input_proj{i}") for i in range(c.num_feature_levels)]
        srcs = [proj(f) for proj, f in zip(projs, feats)]
        for i in range(len(feats), c.num_feature_levels):
            srcs.append(projs[i](srcs[-1] if i > len(feats) else feats[-1]))
        masks = [resize_mask(pad_mask, s.shape[1:3]) for s in srcs]
        poss = [
            sine_position_embedding(m, c.hidden_dim // 2, c.pe_temperature_h,
                                    c.pe_temperature_w)
            for m in masks
        ]
        src_flat, mask_flat, pos_flat, spatial_shapes = flatten_levels(
            srcs, masks, poss, self.level_embed)
        src_flat = src_flat.float()
        vr = torch.stack([valid_ratios(m) for m in masks], dim=1)  # [B, L, 2]

        # ---- encoder ---------------------------------------------------
        enc_ref = encoder_reference_points(spatial_shapes, vr)
        memory = src_flat
        monitor = [] if train else None
        grad = torch.is_grad_enabled()
        enc_saved = DOTS if c.use_checkpoint else MSDA_OUT
        for layer in self.layers("encoder"):
            if grad and (c.use_checkpoint or c.enc_selective_remat):
                def run(src, layer=layer):  # the monitor's entries come out as outputs
                    seen = None if monitor is None else []
                    return layer(src, pos_flat, enc_ref, spatial_shapes, mask_flat,
                                 monitor=seen), seen

                memory, seen = remat(run, memory, saved=enc_saved)
                if monitor is not None:
                    monitor.extend(seen)
            else:
                memory = layer(memory, pos_flat, enc_ref, spatial_shapes, mask_flat,
                               monitor=monitor, generator=gen)

        # ---- two-stage query selection ----------------------------------
        out_memory, out_props_unsig, prop_valid = gen_encoder_output_proposals(
            memory, mask_flat, spatial_shapes)
        out_memory = self.enc_output_norm(self.enc_output(out_memory))
        # selection only: the [B, S, C] logits are not differentiated
        with torch.no_grad():
            scores = self._class_logits(out_memory, text_embed, enc=True).amax(-1)
        scores = scores.masked_fill(~prop_valid, float("-inf"))
        topk_idx = torch.topk(scores, c.num_queries, dim=1).indices  # [B, nq]

        def gather(x):
            return torch.gather(x, 1, topk_idx[..., None].expand(-1, -1, x.shape[-1]))

        tgt_undetach = gather(out_memory)
        ref_undetach = (self.enc_out_bbox_embed(tgt_undetach).float()
                        + gather(out_props_unsig))
        refpoints_unsig = ref_undetach.detach()
        init_box_proposal = torch.sigmoid(gather(out_props_unsig))
        if c.embed_init_tgt:
            tgt = self.tgt_embed[None].expand(b, -1, -1)
        else:
            tgt = tgt_undetach.detach()

        # ---- prepend DN queries -----------------------------------------
        num_dn = 0
        if dn_labels is not None:
            num_dn = dn_labels.shape[1]
            tgt = torch.cat([self.encode_dn_labels(dn_labels, text_embed).to(tgt.dtype),
                             tgt], dim=1)
            refpoints_unsig = torch.cat([dn_boxes_unsig.float(), refpoints_unsig], dim=1)
        self_attn_mask = None if dn_attn_mask is None else dn_attn_mask[:, None]

        if c.use_clip_visual_query and clip_features is not None:
            # content queries from 1x1 RoIs of the teacher's map at the (DN and
            # two-stage) reference boxes; 0 * tgt keeps the embeddings in the graph
            gh, gw = clip_features.shape[1:3]
            x0, y0, x1, y1 = box_cxcywh_to_xyxy(
                torch.sigmoid(refpoints_unsig)).clamp(0.0, 1.0).unbind(-1)
            q_boxes = torch.stack([x0 * gw, y0 * gh, x1 * gw, y1 * gh], -1)  # the map's pixels
            rois = roi_align(clip_features.detach().float(), q_boxes, output_size=1,
                             sampling_ratio=2, method="auto")
            tgt = self.clip_query_proj(rois[:, :, 0, 0, :]) + 0.0 * tgt

        # ---- decoder with iterative box refinement ----------------------
        ref = torch.sigmoid(refpoints_unsig)  # [B, QT, 4]
        references = [ref]
        hs_layers = []
        vr4 = torch.cat([vr, vr], -1)[:, None]  # [B, 1, L, 4]
        for layer in self.layers("decoder"):
            ref_input = ref[:, :, None, :] * vr4
            query_sine = gen_sineembed_for_position(ref_input[:, :, 0, :],
                                                    c.hidden_dim // 2)
            query_pos = self.ref_point_head(query_sine)
            args = (tgt, query_pos, ref_input, memory, spatial_shapes, mask_flat,
                    self_attn_mask)
            if grad and c.use_checkpoint:
                tgt = remat(layer, *args, saved=DOTS)
            else:
                tgt = layer(*args, generator=gen)
            # refinement uses the un-normed layer output; the heads the normed one
            delta = self.bbox_embed(tgt).float()
            new_ref = torch.sigmoid(delta + inverse_sigmoid(ref))
            references.append(new_ref)
            ref = new_ref.detach()
            hs_layers.append(tgt)

        # ---- stacked shared heads ----------------------------------------
        hs_stack = self.decoder_norm(torch.stack(hs_layers))  # [Ld, B, nq, C]
        ref_stack = torch.stack(references[:-1])
        coord_stack = torch.sigmoid(self.bbox_embed(hs_stack).float()
                                    + inverse_sigmoid(ref_stack))
        logit_stack = self._class_logits(hs_stack, text_embed)

        out: Dict[str, Any] = {}
        clip_logits = ch_stack = cl_stack = None
        if c.use_visual_distill:
            # every layer's CLIP outputs when two_stage_cls (training) or
            # distill_aux_layers reads them, else the last layer's
            need_all = (c.two_stage_cls and train) or c.distill_aux_layers
            sel = hs_stack if need_all else hs_stack[-1:]
            ch_stack = l2_normalize(self.distill_proj()(sel).float())
            out["pred_clip_embed"] = ch_stack[-1, :, num_dn:]
            if text_embed is not None:
                t = l2_normalize(text_embed.float())
                cl_stack = torch.exp(self.logit_scale) * (ch_stack @ t.t())
                clip_logits = cl_stack[-1]
                out["pred_clip_logits"] = clip_logits[:, num_dn:]
        if c.two_stage_cls and train and cl_stack is not None:
            # the detached CLIP class probabilities join every layer's logits
            logit_stack = logit_stack + inverse_sigmoid(torch.softmax(cl_stack.detach(), -1))
        out["pred_logits"] = logit_stack[-1, :, num_dn:]
        out["pred_boxes"] = coord_stack[-1, :, num_dn:]
        out["aux_outputs"] = [
            {"pred_logits": lg[:, num_dn:], "pred_boxes": cd[:, num_dn:]}
            for lg, cd in zip(logit_stack[:-1], coord_stack[:-1])
        ]
        if c.distill_aux_layers and ch_stack is not None:
            for lid, aux in enumerate(out["aux_outputs"]):
                aux["pred_clip_embed"] = ch_stack[lid, :, num_dn:]
                if cl_stack is not None:
                    aux["pred_clip_logits"] = cl_stack[lid, :, num_dn:]
        if num_dn:
            out["dn_outputs"] = {
                "pred_logits": logit_stack[-1, :, :num_dn],
                "pred_boxes": coord_stack[-1, :, :num_dn],
                "aux_outputs": [
                    {"pred_logits": lg[:, :num_dn], "pred_boxes": cd[:, :num_dn]}
                    for lg, cd in zip(logit_stack[:-1], coord_stack[:-1])
                ],
            }
            if clip_logits is not None:
                out["dn_outputs"]["pred_clip_logits"] = clip_logits[:, :num_dn]
        interm_class = self._class_logits(tgt_undetach, text_embed, enc=True)
        out["interm_outputs"] = {
            "pred_logits": interm_class,
            "pred_boxes": torch.sigmoid(ref_undetach),
        }
        out["interm_outputs_for_matching_pre"] = {
            "pred_logits": interm_class,
            "pred_boxes": init_box_proposal,
        }
        out["topk_idx"] = topk_idx
        out["hs"] = hs_match = hs_stack[-1, :, num_dn:]
        if c.masks and mask_head and c.mask_head_type == "cond_inst":
            out["mask_feats"] = self.cond_inst.mask_features(srcs[:3])
            out["mask_params"] = self.cond_inst.controller_params(hs_match)
            out["mask_feat_stride"] = self.cond_inst.mask_feat_stride
            out["mask_head_layout"] = self.cond_inst.layout()
        elif c.masks and mask_head:  # DETRsegm on the stride-32, 16 and 8 projections
            c5 = len(feats) - 1
            attn_maps = self.mask_attention(hs_match, srcs[c5], masks[c5])
            out["pred_masks"] = self.mask_head(attn_maps, srcs[c5], srcs[c5 - 1], srcs[c5 - 2])
        if monitor:
            out["offset_beyond_margin"] = torch.stack(monitor).mean()
        return out
