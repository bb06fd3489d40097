"""Retrieval-augmented vision knowledge: the knowledge base, the token
injection module, detection re-scoring, and ROI pooling.

Counterpart of ``hvs_tpu/models/rag.py``. Retrieval is one batched product
against a constant knowledge-embedding matrix and a top-k, and the knowledge
reaches the tokens through cross-attention, all inside the forward (so a
CUDA graph or an exported program holds it).

  * ``build_knowledge_base``: facts about the detection classes with
    deterministic SHA-256-seeded pseudo-embeddings, numpy only, bitwise the
    JAX package's.
  * ``RAGVisionKnowledge``: query projection, top-k retrieval, knowledge
    cross-attention, mHC fusion (``mhc_fuse``: kernel A in serve mode, kernel
    C in a deterministic training forward), residual and LayerNorm.
  * ``KnowledgeAwareDetection``: re-scores fixed-size detections from
    ROI-pooled region features and retrieved knowledge.
  * ``roi_pool_bilinear``: also feeds the serving engine's
    ``return_embeddings`` option.

The knowledge base is a constant in JAX, not a parameter; here it is a
non-persistent buffer rebuilt from the class names, in no checkpoint and in
no converted tree. Dtypes follow the flax modules: ``query_proj`` (and
``region_query``) have no dtype, so they run in fp32 on the fp32 pooled
features; the other projections run in ``dtype``; attention logits and
softmax are fp32.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..constants import COCO_CLASSES
from ..ops.nms import top_k_stable
from .layers import Dense, LayerNorm, ManifoldHyperConnection, gelu, one_hot


def _pseudo_embedding(text: str, dim: int) -> np.ndarray:
    """Deterministic unit-norm pseudo-embedding from a SHA-256-seeded RNG."""
    seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") % (2**32)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(dim).astype(np.float32)
    return v / (np.linalg.norm(v) + 1e-8)


def build_knowledge_base(dim: int = 128, class_names: Optional[Sequence[str]] = None
                         ) -> Tuple[List[str], np.ndarray]:
    """Facts about the detection classes and their embeddings [K, dim]: one
    fact per class (the 80 COCO classes by default; pass the dataset's names
    so the knowledge base matches the task), then five navigation and safety
    facts."""
    facts: List[str] = []
    for name in (class_names if class_names is not None else COCO_CLASSES):
        facts.append(f"A {name} is a common object a humanoid robot may encounter.")
    facts += [
        "People move unpredictably; keep a safe following distance.",
        "Vehicles such as cars, buses and trucks are fast-moving obstacles.",
        "Furniture like chairs, couches and tables are static obstacles.",
        "Small handheld items can be grasped by the manipulator.",
        "Animals may react to robot motion; slow down near them.",
    ]
    emb = np.stack([_pseudo_embedding(t, dim) for t in facts])
    return facts, emb


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class RAGVisionKnowledge(nn.Module):
    """Inject retrieved knowledge into visual tokens [B, T, C]:

        query  = mean-pool(tokens) @ W_q, unit norm          [B, Kd]
        sims   = query @ KB^T                                  [B, K]
        top-k  -> the retrieved knowledge vectors              [B, k, Kd]
        tokens cross-attend into the projected knowledge       [B, T, C]
        out    = LN(x + mHC(concat_proj([x, attended])))

    ``mhc_fuse`` is an mHC layer with expansion and MLP ratio 1 and the
    layer's default dropout (0.1 in train mode) and no telemetry, as in JAX.
    """

    def __init__(self, channels: int = 256, knowledge_dim: int = 128, top_k: int = 5,
                 num_heads: int = 4, sk_iters: int = 20, dtype: torch.dtype = torch.bfloat16,
                 precomputed_constraints: bool = False,
                 kb_classes: Optional[Sequence[str]] = None):
        super().__init__()
        c = channels
        self.channels, self.top_k, self.num_heads, self.dtype = c, top_k, num_heads, dtype
        _, emb = build_knowledge_base(knowledge_dim, kb_classes)
        self.register_buffer("kb", torch.from_numpy(emb), persistent=False)
        self.query_proj = Dense(c, knowledge_dim, dtype=torch.float32)
        self.knowledge_proj = Dense(knowledge_dim, c, dtype=dtype)
        self.xq = Dense(c, c, dtype=dtype)
        self.xk = Dense(c, c, dtype=dtype)
        self.xv = Dense(c, c, dtype=dtype)
        self.concat_proj = Dense(2 * c, c, dtype=dtype)
        self.mhc_fuse = ManifoldHyperConnection(
            c, 1, 1, dtype=dtype, sk_iters=sk_iters,
            precomputed_constraints=precomputed_constraints)
        self.out_norm = LayerNorm(c, dtype=dtype)
        head_dim = c // num_heads
        # jnp.sqrt(float32(head_dim)), exactly: the logits divide by it.
        self._scale = float(np.sqrt(np.float32(head_dim), dtype=np.float32))

    def retrieve(self, x: torch.Tensor) -> torch.Tensor:
        """Indices [B, top_k] of the facts nearest the pooled tokens, best
        first, the lower index first among equal similarities."""
        query = _unit(self.query_proj(x.float().mean(dim=1)))
        return top_k_stable(query @ self.kb.T, self.top_k)[1]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, t, c = tokens.shape
        heads, hd, dt = self.num_heads, c // self.num_heads, self.dtype
        x = tokens.to(dt)
        know = self.knowledge_proj(self.kb[self.retrieve(x)].to(dt))  # [B, k, C]

        def split(a: torch.Tensor, n: int) -> torch.Tensor:
            return a.reshape(b, n, heads, hd).transpose(1, 2)

        q = split(self.xq(x), t)
        k = split(self.xk(know), self.top_k)
        v = split(self.xv(know), self.top_k)
        logits = (q @ k.transpose(-1, -2)).float() / self._scale
        attn = torch.softmax(logits, dim=-1).to(dt)
        attended = (attn @ v).transpose(1, 2).reshape(b, t, c)
        fused = self.concat_proj(torch.cat([x, attended], dim=-1))
        fused = self.mhc_fuse(fused)
        return self.out_norm(x + fused)


def roi_pool_bilinear(feature_map: torch.Tensor, boxes: torch.Tensor,
                      samples: int = 4) -> torch.Tensor:
    """Lightweight ROI-align: bilinear-sample a ``samples`` x ``samples``
    grid inside each box and average.

    Args:
        feature_map: [B, H, W, C].
        boxes: [B, K, 4] normalized xyxy.
    Returns: [B, K, C] region features in fp32.
    """
    bsz, h, w, c = feature_map.shape
    k = boxes.shape[1]
    frac = (torch.arange(samples, dtype=torch.float32, device=boxes.device) + 0.5) / samples
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    xs = x1[..., None] + (x2 - x1)[..., None] * frac  # [B, K, S]
    ys = y1[..., None] + (y2 - y1)[..., None] * frac
    px = torch.clamp(xs * w - 0.5, 0.0, w - 1.0)
    py = torch.clamp(ys * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(px).long()
    y0 = torch.floor(py).long()
    x1i = torch.clamp(x0 + 1, max=w - 1)
    y1i = torch.clamp(y0 + 1, max=h - 1)
    fx = px - x0.float()
    fy = py - y0.float()
    fm = feature_map.float().reshape(bsz, h * w, c)

    def corner(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        # Rows yi and columns xi [B, K, S] -> [B, K, S, S, C].
        flat = (yi[..., :, None] * w + xi[..., None, :]).reshape(bsz, -1)
        picked = torch.gather(fm, 1, flat[..., None].expand(-1, -1, c))
        return picked.reshape(bsz, k, samples, samples, c)

    c00, c01 = corner(y0, x0), corner(y0, x1i)
    c10, c11 = corner(y1i, x0), corner(y1i, x1i)
    wy = fy[..., :, None, None]
    wx = fx[..., None, :, None]
    top = c00 * (1 - wx) + c01 * wx
    bot = c10 * (1 - wx) + c11 * wx
    return (top * (1 - wy) + bot * wy).mean(dim=(2, 3))


class KnowledgeAwareDetection(nn.Module):
    """Re-score fixed-size detections with region features and knowledge.

    Takes a feature map [B, H, W, ``channels``] (the small fused scale) and
    the NMS output (boxes [B, K, 4] normalized xyxy, scores [B, K], classes
    [B, K] with -1 for padding); ROI-pools each region, retrieves the
    ``top_k`` nearest facts of the COCO knowledge base and averages them,
    and blends the class probabilities of a small classifier on both into
    the original scores (``blend``). Padding rows keep their score and -1.
    """

    def __init__(self, channels: int, num_classes: int = 80, knowledge_dim: int = 128,
                 top_k: int = 3, blend: float = 0.5, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.top_k, self.blend, self.dtype = num_classes, top_k, blend, dtype
        _, emb = build_knowledge_base(knowledge_dim)
        self.register_buffer("kb", torch.from_numpy(emb), persistent=False)
        self.region_query = Dense(channels, knowledge_dim, dtype=torch.float32)
        self.cls_hidden = Dense(channels + knowledge_dim, 256, dtype=dtype)
        self.cls_out = Dense(256, num_classes, dtype=dtype)

    def forward(self, feature_map: torch.Tensor, boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor) -> Dict[str, torch.Tensor]:
        region = roi_pool_bilinear(feature_map, boxes)  # [B, K, C] fp32
        query = _unit(self.region_query(region))
        _, idx = top_k_stable(query @ self.kb.T, self.top_k)
        knowledge = self.kb[idx].mean(dim=2)  # [B, K, Kd]
        enhanced = torch.cat([region.to(self.dtype), knowledge.to(self.dtype)], dim=-1)
        logits = self.cls_out(gelu(self.cls_hidden(enhanced)))
        know_probs = torch.softmax(logits.float(), dim=-1)
        onehot = one_hot(classes.clamp(min=0).long(), self.num_classes).float()
        scores = scores.float()
        orig = scores[..., None] * onehot
        refined = (1 - self.blend) * orig + self.blend * know_probs * scores[..., None]
        valid = classes >= 0
        new_classes = torch.where(valid, refined.argmax(dim=-1).to(classes.dtype), classes)
        return {"scores": torch.where(valid, refined.amax(dim=-1), scores),
                "classes": new_classes, "region_features": region}
