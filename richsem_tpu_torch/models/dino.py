"""DINO deformable-DETR detector (counterpart of ``richsem_tpu/models/dino.py``).

R50 backbone -> 4-level input projections -> deformable encoder (K1 sampler,
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
references keeps the undetached boxes) and the offset-saturation monitor. CLIP
query features raise ``NotImplementedError`` (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

import dataclasses
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
    lecun_normal_,
    normal_,
)
from richsem_tpu_torch.models.resnet import ResNet
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
    # memory knobs of the JAX training step; they do not change the eval forward
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to richsem_tpu_torch yet (ROADMAP.md queue 1, {item})"
    )


class DeformableEncoderLayer(nn.Module):
    """Deformable self-attention (K1) -> residual+LN1 -> FFN -> residual+LN2 (K2)."""

    def __init__(self, c: DINOConfig, device=None):
        super().__init__()
        self.compute_dtype = c.compute_dtype
        self.self_attn = MSDeformAttn(
            d_model=c.hidden_dim, n_levels=c.num_feature_levels, n_heads=c.nheads,
            n_points=c.enc_n_points, compute_dtype=c.compute_dtype, impl=c.msda_impl,
            tiled_margin=c.msda_margin, tiled_tile=c.msda_tile,
            clamp_offsets=c.msda_clamp_offsets, device=device,
        )
        self.norm1 = LayerNorm(c.hidden_dim, device=device)
        self.ffn = FFN(c.hidden_dim, c.dim_feedforward, c.activation, c.compute_dtype,
                       device=device)

    def forward(self, src, pos, reference_points, spatial_shapes, pad_mask,
                monitor=None):
        attn_out = self.self_attn(src + pos, reference_points, src, spatial_shapes,
                                  pad_mask, monitor=monitor)
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
        self.self_attn = MultiHeadAttention(c.hidden_dim, c.nheads, c.compute_dtype,
                                            device=device)
        self.norm2 = LayerNorm(c.hidden_dim, device=device)
        self.cross_attn = MSDeformAttn(
            d_model=c.hidden_dim, n_levels=c.num_feature_levels, n_heads=c.nheads,
            n_points=c.dec_n_points, compute_dtype=c.compute_dtype,
            impl=c.dec_msda_impl, device=device,
        )
        self.norm1 = LayerNorm(c.hidden_dim, device=device)
        self.ffn = FFN(c.hidden_dim, c.dim_feedforward, c.activation, c.compute_dtype,
                       device=device)

    def forward(self, tgt, query_pos, reference_points_input, memory, spatial_shapes,
                memory_pad_mask, self_attn_mask=None):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt, mask=self_attn_mask))
        ca = self.cross_attn(tgt + query_pos, reference_points_input, memory,
                             spatial_shapes, memory_pad_mask)
        tgt = self.norm1(tgt + ca)
        return self.ffn(tgt)

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


class ClipAlignHead(nn.Module):
    """Open-vocab classifier: CLIP text dot product (``CLIPAlign.forward_hs``).

    Projects queries into the CLIP joint space (``dino_visual_proj``), L2-normalizes
    both sides in f32, rounds both to ``compute_dtype`` and accumulates their
    product in f32, then scales by exp(logit_scale).
    """

    def __init__(self, c: DINOConfig, use_mlp: bool = False, device=None):
        super().__init__()
        self.compute_dtype = c.compute_dtype
        self.embed_dim = c.clip_embed_dim
        self.dino_visual_proj = _clip_proj(c, use_mlp, device)

    def forward(self, hs, text_embed, logit_scale):
        v = l2_normalize(self.dino_visual_proj(hs).float())
        t = l2_normalize(text_embed.float())
        cd = self.compute_dtype
        logits = v.to(cd).float() @ t.to(cd).float().t()
        return torch.exp(logit_scale) * logits

    def init_weights(self, g: torch.Generator) -> None:
        _init_clip_proj(self.dino_visual_proj, self.embed_dim, g)


class DINO(nn.Module):
    """The detector. Build with ``DINO(cfg, device)``, then ``init_weights(generator)``
    or load a converted state dict (:func:`richsem_tpu_torch.utils.convert.params_from_jax`)."""

    def __init__(self, cfg: DINOConfig, device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DINO builds on 'cuda' unless asked otherwise, and no CUDA device "
                "is available; pass device='cpu' to build on the CPU"
            )
        c = self.cfg = cfg
        if c.backbone not in ("resnet50", "resnet101"):
            raise _not_ported(f"backbone {c.backbone!r}", "item 10")
        for knob in ("masks", "use_clip_visual_query", "share_vl_proj", "enc_cls_agn",
                     "distill_aux_layers"):
            if getattr(c, knob):
                raise _not_ported(f"knob {knob}", "item 10")
        if c.activation != "relu":
            raise _not_ported(f"activation {c.activation!r} in the encoder tail", "item 10")
        if c.two_stage_type != "standard":
            raise NotImplementedError(c.two_stage_type)
        blocks = (3, 4, 6, 3) if c.backbone == "resnet50" else (3, 4, 23, 3)
        self.backbone = ResNet(blocks, c.return_strides, dtype=c.compute_dtype,
                               device=device)
        chans = ResNet.out_channels(c.return_strides)
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
        if c.use_language:
            self.class_embed = ClipAlignHead(
                c, use_mlp=c.use_cls_mlp_proj and c.use_mlp_proj, device=device)
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
        if c.use_visual_distill:
            self.clip_visual_proj = _clip_proj(c, c.use_mlp_proj, device)

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
        if c.use_language:
            self.class_embed.init_weights(g)
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
        if c.use_visual_distill:
            _init_clip_proj(self.clip_visual_proj, c.clip_embed_dim, g)

    def _class_logits(self, h, text_embed, enc: bool = False):
        if self.cfg.use_language:
            head = self.enc_out_class_embed if enc else self.class_embed
            return head(h, text_embed, self.logit_scale)
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
    ) -> Dict[str, Any]:
        feats = self.backbone(images.to(self.cfg.compute_dtype))
        return self.detect(feats, pad_mask, dn_labels=dn_labels,
                           dn_boxes_unsig=dn_boxes_unsig, dn_attn_mask=dn_attn_mask,
                           text_embed=text_embed, clip_features=clip_features,
                           train=train)

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
    ) -> Dict[str, Any]:
        """Input projections -> transformer -> heads, from backbone features.

        With ``train`` the output also holds ``offset_beyond_margin`` (where the
        encoder's windowed-kernel rule applies), and with DN inputs the DN
        queries' outputs under ``dn_outputs``."""
        c = self.cfg
        if clip_features is not None:
            raise _not_ported("CLIP query features", "item 11")
        if (dn_labels is None) != (dn_boxes_unsig is None):
            raise ValueError("dn_labels and dn_boxes_unsig come together")
        if train and c.dropout > 0.0:
            raise _not_ported("dropout in training", "item 11")
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
        for layer in self.layers("encoder"):
            memory = layer(memory, pos_flat, enc_ref, spatial_shapes, mask_flat,
                           monitor=monitor)

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
            tgt = layer(tgt, query_pos, ref_input, memory, spatial_shapes, mask_flat,
                        self_attn_mask)
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
        clip_logits = None
        if c.use_visual_distill:
            clip_hs = l2_normalize(self.clip_visual_proj(hs_stack[-1]).float())
            out["pred_clip_embed"] = clip_hs[:, num_dn:]
            if text_embed is not None:
                t = l2_normalize(text_embed.float())
                clip_logits = torch.exp(self.logit_scale) * (clip_hs @ t.t())
                out["pred_clip_logits"] = clip_logits[:, num_dn:]
        out["pred_logits"] = logit_stack[-1, :, num_dn:]
        out["pred_boxes"] = coord_stack[-1, :, num_dn:]
        out["aux_outputs"] = [
            {"pred_logits": lg[:, num_dn:], "pred_boxes": cd[:, num_dn:]}
            for lg, cd in zip(logit_stack[:-1], coord_stack[:-1])
        ]
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
        out["hs"] = hs_stack[-1, :, num_dn:]
        if monitor:
            out["offset_beyond_margin"] = torch.stack(monitor).mean()
        return out
