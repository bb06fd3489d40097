"""The ViTDet cell's pieces on the CPU: a cut run of its check judged
correct, and judged not correct with a planted fault in the program under
it (the relative positions left out, the windows' padded keys masked, the
position embedding resized by nearest neighbour); and the benchmark's count
of the attention kernel's work against the hand count."""

import json
import sys

import pytest
import torch
import torch.nn.functional as F

from conftest import ROOT, load_config, load_traffic
from perfbench.count import attention

sys.path.insert(0, str(ROOT / "perfbench"))
import run as bench_run  # noqa: E402

CPU = torch.device("cpu")
SIZE = 160  # a 10 x 10 grid, padded to 12 by windows of 4


def tiny_vitdet():
    """``vitdet_b`` cut to width 64, 4 heads, depth 3 (blocks 0-1 windowed,
    2 global), windows of 4 at 160², in fp32."""
    cfg = load_config("vitdet_b")
    cut = dict(embed_dim=64, depth=3, num_heads=4, window_size=4, window_block_indexes=[0, 1],
               pretrain_grid=6, pyramid_channels=32)
    cfg.update(dtype="fp32", input_size=SIZE, head_channels=32, num_classes=6,
               sinkhorn_iterations=5, **cut)
    cfg["model"] = {"input_size": SIZE, "vit": {"enabled": False},
                    "vitdet": {"enabled": True, "dim": 64, "depth": 3, "num_heads": 4,
                               "window_size": 4, "window_block_indexes": [0, 1],
                               "pretrain_grid": 6, "pyramid_channels": 32},
                    "detection": {"num_classes": 6, "head_channels": 32},
                    "mhc": {"sinkhorn_iterations": 5}}
    return cfg


def _run(seed):
    mix = load_traffic("serve_b16_720p_1024")
    mix.update(frame_h=90, frame_w=160, image_size=SIZE, batch=4, pool=8, sample=16)
    cell = {"name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return bench_run.execute(bench, cell, seed, 0.3, 0, CPU, cfg=tiny_vitdet(), traffic=mix)[0]


def _relative_terms_left_out(monkeypatch):
    from hvs_tpu_torch.models import vitdet

    real = vitdet.relative_terms

    def zeros(q, table_h, table_w):
        return tuple(torch.zeros_like(t.contiguous()) for t in real(q, table_h, table_w))

    monkeypatch.setattr(vitdet, "relative_terms", zeros)


def _padded_keys_masked(monkeypatch):
    """In the windowed blocks, keys whose row is all zero (the padding: the
    weights' biases are zero) get -inf."""
    from hvs_tpu_torch.ops import relpos_attention as rp

    def masked(q, k, v, rel_h, rel_w, windowed):
        n, kh, kw, h, d = q.shape
        t = kh * kw

        def heads(a):
            return a.float().reshape(n, t, h, d).transpose(1, 2)

        bias = (rel_h.float().permute(0, 3, 1, 2, 4)[..., :, None]
                + rel_w.float().permute(0, 3, 1, 2, 4)[..., None, :]).reshape(n, h, t, t)
        logits = (heads(q) * d ** -0.5) @ heads(k).transpose(-1, -2) + bias
        if windowed:
            pad = (heads(k) == 0).all(dim=-1)
            logits = logits.masked_fill(pad[:, :, None, :], float("-inf"))
        out = torch.softmax(logits, dim=-1) @ heads(v)
        return out.transpose(1, 2).reshape(n, kh, kw, h, d).to(q.dtype).contiguous()

    monkeypatch.setattr(rp, "relpos_attention", masked)


def _position_embedding_by_nearest(monkeypatch):
    from hvs_tpu_torch.models import vitdet

    def nearest(self):
        pos = self.pos_embed[:, 1:].float()
        side = int(pos.shape[1] ** 0.5)
        grid = pos.reshape(1, side, side, -1).permute(0, 3, 1, 2)
        return F.interpolate(grid, size=(self.grid, self.grid), mode="nearest").permute(0, 2, 3, 1)

    monkeypatch.setattr(vitdet.ViTDetBackbone, "abs_pos", nearest)


def test_a_cut_run_of_the_cell_is_correct():
    line = _run(2700000101)
    assert line["correct"], line["compared"]
    assert line["compared"]["logit_gap"]["value"] < 1e-4


@pytest.mark.parametrize("fault", [_relative_terms_left_out, _padded_keys_masked,
                                   _position_embedding_by_nearest])
@pytest.mark.parametrize("seed", [2700000101, 3000000019])
def test_a_planted_fault_is_not_correct(fault, seed, monkeypatch):
    fault(monkeypatch)
    line = _run(seed)
    assert not line["correct"], line["compared"]


def test_attention_flops_at_the_published_shapes_are_the_hand_count():
    """Per frame at 1024²: a global block 4 · 64 · 12 · 4,096 · 4,096, a
    window block 4 · 64 · 12 · 4,096 · 196 (real queries, each over its
    window's 196 keys)."""
    cfg = load_config("vitdet_b")
    sites = attention.sites(cfg, 1024)
    assert [s.windowed for s in sites] == [i in cfg["window_block_indexes"] for i in range(12)]
    flops = {s.windowed: attention.flops(s, 1) for s in sites}
    assert flops[False] == 4 * 64 * 12 * 4096 * 4096
    assert flops[True] == 4 * 64 * 12 * 4096 * 196
    window = next(s for s in sites if s.windowed)
    assert window.windows == 25 and attention.exponentials(window, 1) == 12 * 4096 * 196
    # bf16 q and out of 4,096 tokens, k and v of 25 padded windows, fp32 terms
    assert attention.bytes_moved(window, 1) == \
        2 * 2 * 4096 * 768 + 2 * 2 * 25 * 196 * 768 + 4 * 4096 * 12 * 28
