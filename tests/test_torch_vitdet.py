"""The port's ViTDet (``models/vitdet.py``) and its attention operators
(``ops/relpos_attention.py``) on the CPU, at tiny sizes: the model against
the benchmark's plain reference (``perfbench/reference/vitdet.py``, written
from detectron2's description), the operators' CPU versions against the
reference's attention and the plain chain, their registration, flop
formulas and fake versions (the kernel's contract on fake CUDA tensors), the
routing of a map by its device, the configuration's guards, and the engine
serving the model on raw frames. The kernel itself runs only on a card
(``test_torch_gpu.py``)."""

import json
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from hvs_tpu_torch.config.inference import InferenceConfig
from hvs_tpu_torch.config.model import ModelConfig
from hvs_tpu_torch.inference import InferenceEngine
from hvs_tpu_torch.models import vitdet
from hvs_tpu_torch.models.constraints import compute_constraints, load_constraints, param_tree
from hvs_tpu_torch.models.vitdet import relative_terms, window_partition, window_unpartition
from hvs_tpu_torch.ops import relpos_attention as rp
from perfbench.harness import program
from perfbench.harness.weights import make_weights
from perfbench.reference import vitdet as ref

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SIZE = 160  # a 10 x 10 grid: windows of 4 pad it to 12, so padding and cropping are exercised
TINY_MODEL = {"input_size": SIZE, "vit": {"enabled": False},
              "vitdet": {"enabled": True, "dim": 64, "depth": 3, "num_heads": 4,
                         "window_size": 4, "window_block_indexes": [0, 1], "pretrain_grid": 6,
                         "pyramid_channels": 32},
              "detection": {"num_classes": 6, "head_channels": 32},
              "mhc": {"sinkhorn_iterations": 5}}


def tiny_vitdet_config():
    """The benchmark's ViTDet-B file cut to width 64, 4 heads, depth 3
    (blocks 0-1 windowed, 2 global), windows of 4 at 160², in fp32."""
    cfg = json.loads((ROOT / "perfbench" / "configs" / "vitdet_b.json").read_text())
    cfg.update(dtype="fp32", input_size=SIZE, embed_dim=64, depth=3, num_heads=4, window_size=4,
               window_block_indexes=[0, 1], pretrain_grid=6, pyramid_channels=32,
               head_channels=32, num_classes=6, sinkhorn_iterations=5, model=TINY_MODEL)
    return cfg


def _mcfg(**changes):
    return ModelConfig(device="cpu", precision="fp32", **{**TINY_MODEL, **changes})


@pytest.mark.parametrize("seed", [12345, 2700000101])
def test_reference_logits_match_the_port(seed):
    """The head's raw maps of the served model (through the engine's load,
    the operator at every attention map) against the plain reference, fp32."""
    cfg = tiny_vitdet_config()
    weights = make_weights(cfg, ref, seed, CPU)
    served = program.build_engine(cfg, weights, SIZE, (2,), CPU)
    x = torch.randn(2, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(seed % 97))
    with torch.no_grad():
        port = served.model(x)["detection"]["raw"]
        mine = ref.Model(cfg, ref.prepare(weights, cfg["sinkhorn_iterations"])).raw(x)
    for key, r in zip(ref.SCALES, mine):
        torch.testing.assert_close(port[key].float(), r, rtol=1e-4, atol=1e-4)


def _reference_attention(q, k, v, table_h, table_w):
    """detectron2's attention with decomposed relative positions, through
    the reference's ``get_rel_pos`` (q, k, v [N, kh, kw, H, D])."""
    n, kh, kw, h, d = q.shape

    def heads(a):
        return a.permute(0, 3, 1, 2, 4).reshape(n * h, kh * kw, d)

    attn = (heads(q) * d ** -0.5) @ heads(k).transpose(-1, -2)
    r_q = heads(q).reshape(n * h, kh, kw, d)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, ref.get_rel_pos(kh, kh, table_h))
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, ref.get_rel_pos(kw, kw, table_w))
    attn = (attn.view(n * h, kh, kw, kh, kw) + rel_h[..., None] + rel_w[..., None, :])
    out = attn.view(n * h, kh * kw, kh * kw).softmax(dim=-1) @ heads(v)
    return out.view(n, h, kh, kw, d).permute(0, 2, 3, 1, 4)


@pytest.mark.parametrize("n,side,heads,table_std", [
    (6, 4, 3, 0.125),    # windows
    (2, 9, 2, 0.125),    # one global grid
    (3, 5, 2, 4.0),      # tables 32 times wider: the bias dominates the logits
])
def test_operator_cpu_version_matches_the_reference_attention(n, side, heads, table_std):
    g = torch.Generator().manual_seed(n * side)
    q, k, v = torch.randn(n, side, side, 3, heads, 64, generator=g).unbind(3)
    tables = [torch.randn(2 * side - 1, 64, generator=g) * table_std for _ in range(2)]
    rel_h, rel_w = relative_terms(q, *tables)
    with torch.no_grad():
        got = rp.relpos_attention(q, k, v, rel_h, rel_w, windowed=side == 4)
    want = _reference_attention(q, k, v, *tables)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if table_std > 1:  # the bias moves the answer far from plain attention
        blind = _reference_attention(q, k, v, *(t * 0 for t in tables))
        assert (got - blind).abs().max() > 0.5


@pytest.mark.parametrize("strided", [True, False])
def test_operator_passes_opcheck_and_counts_no_cpu_launch(strided):
    g = torch.Generator().manual_seed(3)
    q, k, v = torch.randn(2, 3, 5, 3, 2, 64, generator=g).unbind(3)
    rel_h, rel_w = relative_terms(q, torch.randn(5, 64, generator=g),
                                  torch.randn(9, 64, generator=g))
    args = (q, k, v, rel_h, rel_w) if strided else \
        tuple(a.contiguous() for a in (q, k, v, rel_h, rel_w))
    torch.library.opcheck(rp.relpos_attention_op, (*args, True))
    before = (rp.launches_window, rp.launches_global)
    out = torch.ops.hvs.relpos_attention(*args, False)
    assert (rp.launches_window, rp.launches_global) == before
    assert out.is_contiguous() and out.shape == q.shape
    torch.testing.assert_close(out, rp.relpos_attention_plain(*args), rtol=0, atol=0)


def _qkv_tables(n, kh, kw, heads, strided, seed):
    """q, k, v [n, kh, kw, heads, 64] (views of one qkv map, or contiguous
    copies) and fp32 tables of 2kh - 1 and 2kw - 1 rows."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = torch.randn(n, kh, kw, 3, heads, 64, generator=g).unbind(3)
    if not strided:
        q, k, v = (a.contiguous() for a in (q, k, v))
    tables = [torch.randn(2 * side - 1, 64, generator=g) * 0.125 for side in (kh, kw)]
    return q, k, v, *tables


@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("n,kh,kw,heads", [
    (3, 14, 14, 2),    # windows
    (1, 64, 64, 1),    # the global grid at 1024²
    (2, 3, 7, 2),      # ragged grids
    (1, 5, 1, 3),
    (2, 1, 9, 1),
])
def test_tables_operator_cpu_version_is_the_plain_chain_bit_for_bit(n, kh, kw, heads, strided):
    q, k, v, table_h, table_w = _qkv_tables(n, kh, kw, heads, strided, seed=n * kh + kw)
    with torch.no_grad():
        got = rp.relpos_attention_tables(q, k, v, table_h, table_w, windowed=kh == 14)
    want = rp.relpos_attention_plain(q, k, v, *relative_terms(q, table_h, table_w))
    assert got.is_contiguous() and got.shape == q.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("strided", [True, False])
def test_tables_operator_passes_opcheck_and_counts_no_cpu_launch(strided):
    args = _qkv_tables(2, 3, 5, 2, strided, seed=4)
    torch.library.opcheck(rp.relpos_attention_tables_op, (*args, True))
    before = (rp.launches_window, rp.launches_global)
    out = torch.ops.hvs.relpos_attention_tables(*args, False)
    assert (rp.launches_window, rp.launches_global) == before
    torch.testing.assert_close(out, rp.relpos_attention_tables_plain(*args), rtol=0, atol=0)


def _fake_cuda_args(**change):
    """The kernel's arguments as fake CUDA tensors (a 14 x 14 grid, 2 heads,
    q, k, v views of one qkv map), those named in ``change`` replaced."""
    q, k, v = torch.empty(3, 14, 14, 3, 2, 64, dtype=torch.bfloat16, device="cuda").unbind(3)
    args = {"q": q, "k": k, "v": v, "table_h": torch.empty(27, 64, device="cuda"),
            "table_w": torch.empty(27, 64, device="cuda"), **change}
    return [args[n] for n in ("q", "k", "v", "table_h", "table_w")]


def _fake_maps(*shape, dtype=torch.bfloat16):
    return {n: torch.empty(*shape, dtype=dtype, device="cuda") for n in ("q", "k", "v")}


_REFUSED = {
    "head_width_32": (TypeError, lambda: _fake_cuda_args(**_fake_maps(3, 14, 14, 2, 32))),
    "fp16_q": (TypeError, lambda: _fake_cuda_args(**_fake_maps(3, 14, 14, 2, 64,
                                                               dtype=torch.float16))),
    "k_strided_apart": (ValueError, lambda: _fake_cuda_args(
        k=torch.empty(3, 14, 14, 2, 64, dtype=torch.bfloat16, device="cuda"))),
    "grid_over_64": (ValueError, lambda: _fake_cuda_args(**_fake_maps(1, 65, 4, 1, 64))),
    "table_h_rows_of_another_grid": (ValueError, lambda: _fake_cuda_args(
        table_h=torch.empty(25, 64, device="cuda"))),
    "table_w_bf16": (TypeError, lambda: _fake_cuda_args(
        table_w=torch.empty(27, 64, dtype=torch.bfloat16, device="cuda"))),
    "table_w_transposed": (ValueError, lambda: _fake_cuda_args(
        table_w=torch.empty_strided((27, 64), (1, 27), device="cuda"))),
    "table_h_on_the_cpu": (ValueError, lambda: _fake_cuda_args(table_h=torch.empty(27, 64))),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_tables_operator_fake_refuses_what_the_kernel_refuses(case):
    """On fake CUDA tensors the fake version applies the kernel's contract
    (addresses aside): what the card refuses, capture and export refuse."""
    error, make = _REFUSED[case]
    with FakeTensorMode():
        out = rp.relpos_attention_tables(*_fake_cuda_args(), True)
        assert out.shape == (3, 14, 14, 2, 64) and out.is_cuda
        with pytest.raises(error):
            rp.relpos_attention_tables(*make(), True)


def test_terms_operator_raises_on_a_cuda_map_naming_the_tables_operator():
    with FakeTensorMode():
        q, k, v, table_h, table_w = _fake_cuda_args()
        rel_h = torch.empty(3, 14, 14, 2, 14, device="cuda")
        with pytest.raises(RuntimeError, match="relpos_attention_tables"):
            rp.relpos_attention(q, k, v, rel_h, rel_h, True)


@pytest.mark.parametrize("n,side,heads", [(400, 14, 12), (16, 64, 12), (2, 5, 3)])
def test_tables_flop_formula_is_the_plain_chains_count(n, side, heads):
    """On the meta device the operator counts what ``relative_terms``'
    product and ``hvs::relpos_attention`` count, so the port's count does not
    depend on which of the two a map takes."""
    meta = torch.device("meta")
    q, k, v = torch.empty(n, side, side, 3, heads, 64, device=meta).unbind(3)
    tables = [torch.empty(2 * side - 1, 64, device=meta) for _ in range(2)]
    with FlopCounterMode(display=False) as fused:
        rp.relpos_attention_tables(q, k, v, *tables, True)
    with FlopCounterMode(display=False) as chain:
        rp.relpos_attention(q, k, v, *relative_terms(q, *tables), True)
    assert fused.get_total_flops() == chain.get_total_flops() > 4 * n * heads * side ** 4 * 64


def _forward_before_the_tables_operator(self, x):
    """``RelPosAttention.forward`` as it was when every map made its terms
    first: ``relative_terms``, then the plain version with autograd on, or
    ``hvs::relpos_attention`` with it off."""
    n, kh, kw, c = x.shape
    q, k, v = self.qkv(x).view(n, kh, kw, 3, self.num_heads, -1).unbind(3)
    rel_h, rel_w = relative_terms(q, self.rel_pos_h, self.rel_pos_w)
    attend = rp.relpos_attention_plain if torch.is_grad_enabled() else rp.relpos_attention
    return self.proj(attend(q, k, v, rel_h, rel_w, self.windowed).view(n, kh, kw, c))


def test_cpu_forward_is_bit_equal_to_the_routing_before_the_tables_operator(monkeypatch):
    model = _mcfg().build_model(production=True).eval()
    load_constraints(model, compute_constraints(param_tree(model), 5))
    x = torch.randn(2, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        now = model(x)["detection"]["raw"]
        monkeypatch.setattr(vitdet.RelPosAttention, "forward", _forward_before_the_tables_operator)
        before = model(x)["detection"]["raw"]
    for key in before:
        torch.testing.assert_close(now[key], before[key], rtol=0, atol=0)


@pytest.mark.parametrize("device,grad,taken", [
    ("cuda", False, {"tables": 1, "terms": 0, "attention": 0}),
    ("cpu", False, {"tables": 0, "terms": 1, "attention": 1}),
    ("cpu", True, {"tables": 0, "terms": 1, "attention": 0}),
])
def test_a_map_routes_by_its_device_and_autograd(device, grad, taken, monkeypatch):
    """A CUDA map (fake tensors here) with autograd off goes to the tables
    operator and never makes the terms; a CPU map makes them and attends
    through ``hvs::relpos_attention``, or with autograd on the plain version.
    (Autograd on fake CUDA tensors needs a CUDA build: the card test holds
    that path.)"""
    calls = dict.fromkeys(taken, 0)

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(rp, "relpos_attention_tables",
                        counted("tables", rp.relpos_attention_tables))
    monkeypatch.setattr(rp, "relpos_attention", counted("attention", rp.relpos_attention))
    monkeypatch.setattr(vitdet, "relative_terms", counted("terms", vitdet.relative_terms))
    with FakeTensorMode() if device == "cuda" else nullcontext(), torch.device(device):
        attn = vitdet.RelPosAttention(128, 2, 14, windowed=True).requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            out = attn(torch.zeros(3, 14, 14, 128))
    assert out.shape == (3, 14, 14, 128) and out.device.type == device
    assert calls == taken


def test_windows_pad_partition_and_crop_back():
    x = torch.randn(2, 10, 10, 3)
    windows, padded = window_partition(x, 4)
    assert windows.shape == (2 * 9, 4, 4, 3) and padded == (12, 12)
    assert windows[8, 2:].abs().sum() == 0  # the last window's bottom rows are padding
    torch.testing.assert_close(window_unpartition(windows, 4, padded, (10, 10)), x)


@pytest.mark.parametrize("option", [{"vit": {"enabled": True}}, {"rag": {"enabled": True}},
                                    {"use_segmentation": True}, {"use_depth": True},
                                    {"quantization": {"enabled": True}}])
def test_build_model_refuses_each_hybrid_option(option):
    with pytest.raises(ValueError, match=next(iter(option))):
        _mcfg(**option).build_model(production=True)


def test_vitdet_config_builds_the_detector_and_leaves_the_hybrid_as_it_was():
    model = _mcfg().build_model(production=True)
    assert type(model).__name__ == "ViTDetDetector"
    assert model.backbone.block2.attn.rel_pos_h.shape == (2 * SIZE // 16 - 1, 16)
    assert model.backbone.block0.attn.rel_pos_h.shape == (7, 16)
    hybrid = ModelConfig(device="cpu")
    assert not hybrid.vitdet.enabled
    assert type(hybrid.build_model(production=True)).__name__ == "ProductionHybridVision"
    with pytest.raises(ValueError, match="detection task"):
        _mcfg().build_model(task="multi_task")


def _frames(n, h=90, w=160):
    r = np.random.default_rng(n)
    return [r.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def test_engine_serves_the_model_on_raw_frames_and_refuses_another_size():
    icfg = InferenceConfig(device="cpu", preprocessing={"image_size": SIZE},
                           postprocessing={"score_threshold": 0.05},
                           performance={"batch_buckets": (2,)})
    served = InferenceEngine(_mcfg(), icfg, device="cpu")
    served.register_raw_shape((90, 160))
    dets = served.infer_batch(_frames(2))
    assert len(dets) == 2 and served.eager_batches == 0
    for d in dets:
        assert d.image_size == (90, 160) and np.isfinite(d.boxes).all()
        assert (d.boxes[:, [0, 2]] <= 160).all() and (d.boxes[:, [1, 3]] <= 90).all()
    with pytest.raises(ValueError, match="input_size"):
        InferenceEngine(_mcfg(), InferenceConfig(device="cpu",
                                                 preprocessing={"image_size": 128}),
                        device="cpu")
    with pytest.raises(ValueError, match="patch grid"):
        with torch.no_grad():
            served.model(torch.zeros(1, 128, 128, 3))


def test_autograd_takes_the_plain_chain_and_reaches_the_tables():
    model = _mcfg().build_model(production=False).train()
    out = model(torch.randn(1, SIZE, SIZE, 3))
    sum(r.sum() for r in out["detection"]["raw"].values()).backward()
    for i in range(3):
        assert model.backbone.get_submodule(f"block{i}").attn.rel_pos_w.grad.abs().sum() > 0
    assert model.backbone.pos_embed.grad[:, 1:].abs().sum() > 0
