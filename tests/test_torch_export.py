"""Kernel A as the registered operator ``hvs::mhc_block`` and the serve
function under ``torch.export``, on the CPU.

The operator's fake version gives the kernel's output shape and raises on
what the kernel refuses; an exported bf16 model records the operator at
every fused site, and its loaded program equals the eager serve function;
the NMS takes its export branch (all M fixed-point sweeps, no host check)
and keeps exactly what the eager loop keeps. The program against JAX's
StableHLO export is in ``tests/test_torch_deployment.py``.
"""

import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from hvs_tpu_torch.deployment.model_server import ModelExporter
from hvs_tpu_torch.models import ProductionHybridVision
from hvs_tpu_torch.models.constraints import compute_constraints, load_constraints, param_tree
from hvs_tpu_torch.models.layers import ManifoldHyperConnection
from hvs_tpu_torch.ops import mhc_block as mhc_mod
from hvs_tpu_torch.ops.nms import _greedy_fixed_point, nms_fixed

torch.set_num_threads(1)

# tests/test_torch_serve.py's tiny model: mHC sites at d = 32, 64 and 128
# (bottlenecks) and 64 (FPN levels, head towers) run the fused block.
TINY = dict(num_classes=3, stage_blocks=(1, 1, 1, 1), stage_channels=(32, 64, 128, 256),
            vit_dim=64, vit_depth=1, vit_heads=4, fpn_channels=64, head_channels=64,
            sk_iters=5)


def _block_args(n, d, seed=0):
    r = np.random.default_rng(seed)
    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    x = t(r.standard_normal((n, d)), bf)
    mats = [t(r.standard_normal((d, d)) / math.sqrt(d), bf) for _ in range(4)]
    vecs = [t(0.01 * r.standard_normal(d)) for _ in range(2)]
    ln = [t(1 + 0.1 * r.standard_normal(d)), t(0.1 * r.standard_normal(d)),
          t(1 + 0.1 * r.standard_normal(d)), t(0.1 * r.standard_normal(d))]
    return x, [mats[0], vecs[0], mats[1], vecs[1], mats[2], mats[3]] + ln


@pytest.mark.parametrize("d", mhc_mod.SUPPORTED_WIDTHS)
def test_register_fake_gives_the_kernel_output(d):
    x, args = _block_args(37, d, seed=d)
    mode = FakeTensorMode()
    fx, fargs = mode.from_tensor(x), [mode.from_tensor(a) for a in args]
    with mode:
        out = mhc_mod.mhc_block(fx, *fargs)
    assert out.shape == (37, d) and out.dtype == torch.bfloat16
    assert out.stride() == x.stride() and out.device == x.device


def test_register_fake_refuses_what_the_kernel_refuses():
    x, args = _block_args(16, 64)
    mode = FakeTensorMode()
    fx, fargs = mode.from_tensor(x), [mode.from_tensor(a) for a in args]
    with mode:
        with pytest.raises(TypeError):
            mhc_mod.mhc_block(fx.float(), *fargs)
        with pytest.raises(ValueError):
            mhc_mod.mhc_block(fx[:, :48], *fargs)  # no kernel width
        with pytest.raises(ValueError):
            mhc_mod.mhc_block(fx.t().contiguous().t(), *fargs)  # not contiguous
        bad = list(fargs)
        bad[1] = bad[1].to(torch.bfloat16)  # b1 must be fp32
        with pytest.raises(ValueError):
            mhc_mod.mhc_block(fx, *bad)


def test_operator_passes_opcheck_and_counts_no_cpu_launch():
    x, args = _block_args(50, 32, seed=5)
    torch.library.opcheck(mhc_mod.mhc_block_op, (x, *args))
    before = mhc_mod.launches
    out = torch.ops.hvs.mhc_block(x, *args)
    assert mhc_mod.launches == before
    torch.testing.assert_close(out, mhc_mod.mhc_block_plain(x, *args), rtol=0, atol=0)


def test_export_records_kernel_a_at_every_fused_site(tmp_path):
    model = ProductionHybridVision(device="cpu", **TINY).eval()
    load_constraints(model, compute_constraints(param_tree(model), TINY["sk_iters"]))
    sites = sum(m.fused for m in model.modules() if isinstance(m, ManifoldHyperConnection))
    assert sites >= 8
    exporter = ModelExporter(model, image_size=64)
    path = exporter.export_program(str(tmp_path / "model.pt2"), batch=2)
    program = exporter.load_program(path)
    nodes = [n for n in program.graph.nodes if "hvs.mhc_block" in str(n.target)]
    assert len(nodes) == sites
    x = exporter.example_input(2)
    before = mhc_mod.launches
    with torch.no_grad():
        got, want = program(x), exporter._serve_fn()(x)
    assert mhc_mod.launches == before  # the CPU takes the plain version
    assert got[0].shape == (2, 100, 4) and got[2].dtype == torch.int32
    for a, b in zip(got, want):
        assert torch.equal(a, b)


class _Keep(torch.nn.Module):
    def forward(self, suppress, valid):
        return _greedy_fixed_point(suppress, valid)


def _chains(seed, batch=3, m=48):
    """Suppression matrices with long chains (i suppresses i+1 often), so
    that the greedy result takes many sweeps."""
    r = np.random.default_rng(seed)
    s = r.uniform(size=(batch, m, m)) < 0.08
    s |= np.eye(m, k=1, dtype=bool) & (r.uniform(size=(batch, m, m)) < 0.8)
    s = np.triu(s, 1)
    valid = r.uniform(size=(batch, m)) < 0.9
    return torch.from_numpy(s), torch.from_numpy(valid)


def test_nms_export_branch_keeps_what_the_eager_loop_keeps():
    suppress, valid = _chains(0)
    program = torch.export.export(_Keep(), (suppress, valid), strict=False).module()
    sweeps = sum("baddbmm" in str(n.target) for n in program.graph.nodes)
    assert sweeps == suppress.shape[-1]  # all M sweeps, no host check
    for seed in range(5):
        suppress, valid = _chains(seed)
        eager = _greedy_fixed_point(suppress, valid)
        assert torch.equal(program(suppress, valid), eager)
        # The greedy result itself, walked in score order.
        for b in range(suppress.shape[0]):
            kept = np.zeros(suppress.shape[-1], bool)
            for j in range(suppress.shape[-1]):
                kept[j] = bool(valid[b, j]) and not (kept & suppress[b, :, j].numpy()).any()
            np.testing.assert_array_equal(eager[b].numpy(), kept)


def test_nms_fixed_exported_equals_eager():
    class Nms(torch.nn.Module):
        def forward(self, boxes, scores, classes):
            r = nms_fixed(boxes, scores, classes, iou_threshold=0.3, score_threshold=0.2,
                          max_detections=20, pre_nms_top_k=64)
            return r.boxes, r.scores, r.classes, r.num_valid

    def inputs(seed):
        r = np.random.default_rng(seed)
        xy = r.uniform(0, 0.8, (2, 200, 2))
        wh = r.uniform(0.05, 0.3, (2, 200, 2))
        boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))
        return (boxes, torch.from_numpy(r.uniform(size=(2, 200)).astype(np.float32)),
                torch.from_numpy(r.integers(0, 3, (2, 200)).astype(np.int32)))

    program = torch.export.export(Nms(), inputs(0), strict=False).module()
    for seed in range(3):
        args = inputs(seed)
        for a, b in zip(program(*args), Nms()(*args)):
            assert torch.equal(a, b)


def test_export_model_entry_point_on_the_cpu(tmp_path):
    import json

    from hvs_tpu_torch import export_model

    report = export_model.main(["--tiny", "--device", "cpu", "--output", str(tmp_path)])
    assert report["pt2"]["consistency"]["consistent"], report
    assert report["weights"]["bytes"] > 0
    assert json.loads((tmp_path / "export_report.json").read_text()) == \
        json.loads(json.dumps(report, default=str))
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["export_report.json", "model.pt2", "weights.pt"]


def test_deploy_builds_its_engine_on_the_cpu_when_asked():
    from hvs_tpu_torch import deploy

    args = deploy.parse_args(["serve", "--backend", "grpc", "--tiny", "--device", "cpu",
                              "--port", "0"])
    engine = deploy.build_engine(args)
    assert engine.device.type == "cpu" and engine.image_size == 64
    assert (args.backend, args.port) == ("grpc", 0)


def test_deployment_entry_points_raise_without_a_card(tmp_path):
    from hvs_tpu_torch import deploy, export_model

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_model.main(["--tiny", "--output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deploy.build_engine(deploy.parse_args(["serve", "--tiny"]))
    assert not list(tmp_path.iterdir())
