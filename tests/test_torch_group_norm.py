"""GroupNorm's operators ``hvs::gn_stats``, ``hvs::gn_apply`` and
``hvs::gn_apply_tail`` (``hvs_tpu_torch/ops/group_norm.py``) on the CPU.

Their plain versions give the plain chain's bits: ``F.silu(GroupNorm(x))``
and the folded serve tail of ``ConvMHCBlock`` as they were written before the
operators (the references below), with the identity and the projected
shortcut, without SE and with a GroupNorm ablated to ``nn.Identity``, and
for maps of any float type and width. The fake versions export and hold a
CUDA map to the kernels' contract; the dispatch rule sends autograd to the
plain chain and every map with autograd off to the operators, and never
launches a kernel on the CPU; a serve forward of each configuration reaches
the operators at every GroupNorm site. The kernels
themselves are held against these plain versions on the card
(``tests/test_torch_gpu.py``).
"""

from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from hvs_tpu_torch.models import LightweightHybridVision, ProductionHybridVision
from hvs_tpu_torch.models.backbone import ConvMHCBlock
from hvs_tpu_torch.models.constraints import compute_constraints, load_constraints, param_tree
from hvs_tpu_torch.models.layers import GroupNorm, group_norm, init_weights, silu_norm
from hvs_tpu_torch.ops import group_norm as gn_ops
from hvs_tpu_torch.utils.perf import identity_norms

torch.set_num_threads(1)
BF = torch.bfloat16
OPS = ("gn_stats", "gn_apply", "gn_apply_tail")


def _map(shape, seed, scale=1.5, shift=0.3, dtype=BF):
    r = np.random.default_rng(seed)
    return torch.from_numpy((shift + scale * r.standard_normal(shape)).astype(np.float32)) \
        .to(dtype)


def _norm(c, seed, dtype=BF):
    gn = group_norm(c, dtype)
    r = np.random.default_rng(seed)
    with torch.no_grad():
        gn.scale.copy_(torch.from_numpy(r.uniform(0.5, 1.5, c).astype(np.float32)))
        gn.bias.copy_(torch.from_numpy(r.uniform(-0.5, 0.5, c).astype(np.float32)))
    return gn


def _reference_group_norm(gn: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """``GroupNorm.forward`` as the plain chain computes it."""
    x32 = x.float()
    spatial = tuple(range(1, x.dim() - 1))
    s, t = gn.affine_from_channel_stats(x32.mean(dim=spatial), x32.square().mean(dim=spatial))
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    return (x32 * s.reshape(shape) + t.reshape(shape)).to(gn.dtype)


def _reference_tail(block: ConvMHCBlock, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The folded serve tail as ``ConvMHCBlock`` computed it in fp32 torch
    operations before the operators."""
    y32 = y.float()
    s = t = ch_mean = None
    if not isinstance(block.GroupNorm_2, nn.Identity):
        ch_mean = y32.mean(dim=(1, 2))
        s, t = block.GroupNorm_2.affine_from_channel_stats(ch_mean, y32.square().mean(dim=(1, 2)))
    if block.se is not None:
        if ch_mean is None:
            ch_mean = y32.mean(dim=(1, 2))
        pooled = ch_mean if s is None else ch_mean * s + t
        g = block.se(pooled=pooled.to(block.dtype), return_gates=True).float()
        s, t = (g, None) if s is None else (s * g, t * g)
    out = y32 if s is None else y32 * s[:, None, None, :]
    if t is not None:
        out = out + t[:, None, None, :]
    if block.shortcut is None:
        out = out + x.float()
    elif isinstance(block.GroupNorm_3, nn.Identity):
        out = out + block.shortcut(x).float()
    else:
        sc32 = block.shortcut(x).float()
        s2, t2 = block.GroupNorm_3.affine_from_channel_stats(
            sc32.mean(dim=(1, 2)), sc32.square().mean(dim=(1, 2)))
        out = out + sc32 * s2[:, None, None, :] + t2[:, None, None, :]
    return F.silu(out).to(block.dtype)


class _Calls(TorchDispatchMode):
    """Records the ``hvs::gn_*`` operators dispatched, with their first
    argument's shape and, for tails, whether the shortcut is normalised."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in OPS:
            extra = (args[4] is not None) if name == "gn_apply_tail" else \
                (args[6] if name == "gn_apply" else None)
            self.calls.append((name, tuple(args[0].shape), extra))
        return func(*args, **(kwargs or {}))


@contextmanager
def _no_launches():
    before = (gn_ops.launches_stats, gn_ops.launches_apply)
    yield
    assert (gn_ops.launches_stats, gn_ops.launches_apply) == before


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", [(2, 9, 11, 16), (3, 40, 24), (1, 5, 7, 40), (2, 4, 4, 64)])
def test_operators_give_the_plain_group_norm_bits(shape, silu):
    x = _map(shape, seed=sum(shape))
    gn = _norm(shape[-1], seed=shape[-1])
    want = _reference_group_norm(gn, x)
    want = F.silu(want) if silu else want
    with torch.no_grad(), _no_launches():
        stats = torch.ops.hvs.gn_stats(x)
        got = torch.ops.hvs.gn_apply(x, stats, gn.scale, gn.bias, gn.num_groups, gn.epsilon,
                                     silu)
        via_module = silu_norm(gn, x) if silu else gn(x)
    hw = int(np.prod(shape[1:-1]))
    assert stats.shape == (shape[0], gn_ops.num_slices(hw, shape[-1]), 2, shape[-1])
    assert torch.equal(got, want) and torch.equal(via_module, want)


@pytest.mark.parametrize("dtype,c", [(torch.float32, 16), (torch.float16, 24), (BF, 20),
                                     (torch.float32, 12)])
def test_operators_take_any_map_on_the_cpu(dtype, c):
    """A map outside the kernels' contract (fp32, fp16, C not a multiple of
    8) still goes through the operators with autograd off, and their plain
    versions give the plain chain's bits."""
    x = _map((2, 7, 9, c), seed=c, dtype=dtype)
    gn = _norm(c, seed=c, dtype=dtype)
    want = F.silu(_reference_group_norm(gn, x))
    mode = _Calls()
    with torch.no_grad(), mode, _no_launches():
        got = silu_norm(gn, x)
    assert [call[0] for call in mode.calls] == ["gn_stats", "gn_apply"]
    assert got.dtype == dtype and torch.equal(got, want)


def _block(in_ch, ch, stride, seed, use_se=True, ablate=None):
    block = ConvMHCBlock(in_ch, ch, stride, dtype=BF, use_mhc=False, use_se=use_se,
                         precomputed_constraints=True)
    init_weights(block, seed)
    for name in ("GroupNorm_2", "GroupNorm_3"):
        if hasattr(block, name):
            setattr(block, name, _norm(ch, seed=seed + len(name)))
    if ablate:
        setattr(block, ablate, nn.Identity())
    return block.eval()


TAILS = {  # (in_ch, ch, stride, use_se, GroupNorm ablated)
    "identity_shortcut": (32, 32, 1, True, None),
    "projected_shortcut": (16, 40, 2, True, None),
    "no_se": (16, 24, 2, False, None),
    "identity_norm": (24, 24, 1, True, "GroupNorm_2"),
    "identity_norm_no_se": (24, 24, 1, False, "GroupNorm_2"),
    "identity_shortcut_norm": (16, 32, 1, True, "GroupNorm_3"),
}


@pytest.mark.parametrize("case", sorted(TAILS))
def test_folded_tail_gives_the_plain_bits(case):
    in_ch, ch, stride, use_se, ablate = TAILS[case]
    block = _block(in_ch, ch, stride, seed=len(case), use_se=use_se, ablate=ablate)
    x = _map((2, 12, 10, in_ch), seed=in_ch)
    y = _map((2, 12 // stride, 10 // stride, ch), seed=ch, scale=2.0, shift=-0.4)
    with torch.no_grad():
        want = _reference_tail(block, x, y)
        mode = _Calls()
        with mode, _no_launches():
            got = block._folded_tail(x, y)
    with torch.enable_grad():
        plain = block._folded_tail(x, y)
    assert torch.equal(got, want) and torch.equal(plain.detach(), want)
    tails = [c for c in mode.calls if c[0] == "gn_apply_tail"]
    normed_shortcut = (stride != 1 or in_ch != ch) and ablate != "GroupNorm_3"
    assert len(tails) == 1 and tails[0][2] == normed_shortcut


def test_block_forward_takes_the_folded_tail_through_the_operators():
    block = _block(16, 64, 2, seed=3)  # bottleneck width 32
    x = _map((2, 8, 8, 16), seed=1)
    mode = _Calls()
    with torch.no_grad(), mode, _no_launches():
        got = block(x)
    with torch.enable_grad():
        want = block(x)
    assert torch.equal(got, want.detach())
    names = [c[0] for c in mode.calls]
    # reduce and spatial: GroupNorm + SiLU; the tail: y's and the shortcut's statistics.
    assert names.count("gn_apply") == 2 and names.count("gn_apply_tail") == 1
    assert names.count("gn_stats") == 4


def _fake(t, mode):
    return None if t is None else mode.from_tensor(t)


def test_fake_versions_give_the_kernels_outputs_and_refuse_what_they_refuse():
    x = _map((3, 20, 21, 24), seed=2)
    gn = _norm(24, seed=2)
    mode = FakeTensorMode()
    with mode:
        # Fake CUDA tensors: the kernels' contract holds.
        fx = torch.empty(x.shape, dtype=BF, device="cuda")
        fs, fb = (torch.empty(24, device="cuda") for _ in range(2))
        stats = torch.ops.hvs.gn_stats(fx)
        out = torch.ops.hvs.gn_apply(fx, stats, fs, fb, 8, 1e-5, True)
        tail = torch.ops.hvs.gn_apply_tail(fx, None, None, fx, stats, fs, fb, 8, 1e-5)
        assert stats.shape == (3, gn_ops.num_slices(420, 24), 2, 24) == (3, 5, 2, 24)
        assert stats.dtype == torch.float32 and stats.is_cuda
        assert out.shape == x.shape and out.dtype == BF and tail.shape == x.shape
        f32 = fx.float()
        assert torch.ops.hvs.gn_apply(f32, stats, fs, fb, 8, 1e-5, False).dtype == \
            torch.float32
        with pytest.raises(TypeError):
            torch.ops.hvs.gn_stats(fx.double())
        with pytest.raises(ValueError):
            torch.ops.hvs.gn_apply_tail(fx, None, None, f32, None, None, None, 1, 0.0)
        # (Made whole: a view of a fake CUDA tensor needs a CUDA build.)
        assert torch.ops.hvs.gn_stats(torch.empty(3, 20, 21, 20, dtype=BF, device="cuda")) \
            .shape == (3, gn_ops.num_slices(420, 20), 2, 20)
        with pytest.raises(ValueError):  # C not a multiple of 4
            torch.ops.hvs.gn_stats(torch.empty(3, 20, 21, 18, dtype=BF, device="cuda"))
        with pytest.raises(ValueError):  # not contiguous
            torch.ops.hvs.gn_stats(torch.empty_strided(
                x.shape, (20 * 21 * 24, 24, 20 * 24, 1), dtype=BF, device="cuda"))
        with pytest.raises(ValueError):
            torch.ops.hvs.gn_apply(fx, torch.empty(3, 2, 2, 24, device="cuda"), fs, fb, 8,
                                   1e-5, True)
        with pytest.raises(ValueError):
            torch.ops.hvs.gn_apply(fx, stats, fs, fb, 5, 1e-5, True)  # groups
        with pytest.raises(ValueError):
            torch.ops.hvs.gn_apply_tail(fx, None, None,
                                        torch.empty(2, 20, 21, 24, dtype=BF, device="cuda"),
                                        None, None, None, 1, 0.0)
    # Fake CPU tensors take the plain versions' shapes, whatever the map.
    cpu = mode.from_tensor(_map((2, 5, 5, 20), seed=3, dtype=torch.float64))
    with mode:
        stats = torch.ops.hvs.gn_stats(cpu)
        assert stats.shape == (2, gn_ops.num_slices(25, 20), 2, 20)


@pytest.mark.parametrize("op", OPS)
def test_operators_pass_opcheck(op):
    x = _map((2, 6, 5, 16), seed=4)
    gn = _norm(16, seed=4)
    stats = gn_ops.gn_stats_plain(x)
    s = torch.rand(2, 16)
    args = {"gn_stats": (x,),
            "gn_apply": (x, stats, gn.scale.detach(), gn.bias.detach(), 8, 1e-5, True),
            "gn_apply_tail": (x, s, s, x, stats, gn.scale.detach(), gn.bias.detach(), 8,
                              1e-5)}[op]
    torch.library.opcheck(getattr(torch.ops.hvs, op).default, args)


class _Sites(nn.Module):
    """A GroupNorm + SiLU site and a bottleneck block with a projected
    shortcut, in serve mode."""

    def __init__(self):
        super().__init__()
        self.GroupNorm_0 = _norm(16, seed=7)
        self.block = _block(16, 32, 2, seed=7)

    def forward(self, x):
        return self.block(silu_norm(self.GroupNorm_0, x.to(BF)))


def test_export_records_the_operators_and_runs_as_eager():
    model = _Sites().eval()
    x = _map((2, 8, 8, 16), seed=9)
    with torch.no_grad():
        program = torch.export.export(model, (x,), strict=False)
        got, want = program.module()(x), model(x)
    names = [str(n.target) for n in program.graph.nodes if "hvs.gn_" in str(n.target)]
    assert sum("gn_stats" in n for n in names) == 5
    assert sum("gn_apply_tail" in n for n in names) == 1
    assert sum(n.startswith("hvs.gn_apply.") for n in names) == 3
    assert torch.equal(got, want)


def test_dispatch_rule_cpu_autograd_and_fp32():
    x = _map((2, 6, 6, 32), seed=11)
    gn = _norm(32, seed=11)
    # A CPU tensor with autograd off: the operators, their plain versions.
    mode = _Calls()
    with torch.no_grad(), mode, _no_launches():
        a = gn(x, silu=True)
        assert gn_ops.engaged()
    assert [c[0] for c in mode.calls] == ["gn_stats", "gn_apply"]
    # Autograd on: the plain chain, no operator.
    mode = _Calls()
    with torch.enable_grad(), mode, _no_launches():
        b = gn(x.requires_grad_(), silu=True)
        assert not gn_ops.engaged()
    assert mode.calls == [] and b.requires_grad
    assert torch.equal(a, b.detach())
    # An fp32 model with autograd off: the operators too, with the chain's bits.
    gn32 = GroupNorm(32, 8, dtype=torch.float32)
    mode = _Calls()
    with torch.no_grad(), mode, _no_launches():
        c = gn32(x.detach().float())
    assert [call[0] for call in mode.calls] == ["gn_stats", "gn_apply"]
    with torch.enable_grad():
        assert torch.equal(c, gn32(x.detach().float()).detach())


SITES = {  # GroupNorm + SiLU sites, folded tails, projected shortcuts
    "flagship": (ProductionHybridVision, {}, (33, 11, 3)),
    "lightweight": (LightweightHybridVision,
                    dict(precomputed_constraints=True, dropout_rate=0.0), (23, 6, 3)),
}


@pytest.mark.parametrize("name", sorted(SITES))
def test_serve_forward_reaches_the_operators_at_every_site(name):
    cls, kw, (silu_sites, tails, projected) = SITES[name]
    model = cls(seed=1, device="cpu", sk_iters=3, **kw).eval()
    load_constraints(model, compute_constraints(param_tree(model), 3))
    x = torch.from_numpy(np.random.default_rng(5).uniform(size=(1, 64, 64, 3))
                         .astype(np.float32))
    mode = _Calls()
    with torch.inference_mode(), mode, _no_launches():
        model(x)
    applies = [c for c in mode.calls if c[0] == "gn_apply"]
    tail_calls = [c for c in mode.calls if c[0] == "gn_apply_tail"]
    assert len(applies) == silu_sites and all(c[2] for c in applies)
    assert len(tail_calls) == tails and sum(c[2] for c in tail_calls) == projected
    assert sum(c[0] == "gn_stats" for c in mode.calls) == silu_sites + tails + projected


def test_ablated_norms_keep_working_on_the_operator_path():
    model = ProductionHybridVision(seed=2, device="cpu", sk_iters=3, stage_blocks=(1, 1, 1, 1),
                                   stage_channels=(16, 24, 32, 40), vit_dim=16, vit_depth=1,
                                   vit_heads=2, fpn_channels=16, head_channels=16).eval()
    load_constraints(model, compute_constraints(param_tree(model), 3))
    assert identity_norms(model.backbone) > 0
    x = torch.from_numpy(np.random.default_rng(6).uniform(size=(2, 64, 64, 3))
                         .astype(np.float32))
    with torch.no_grad():
        a = model(x)["detection"]["raw"]
    with torch.enable_grad():
        b = model(x)["detection"]["raw"]
    for k in a:
        assert torch.equal(a[k], b[k].detach())


@pytest.mark.parametrize("hw,c", [(16, 16), (400, 512), (999, 24), (102400, 32), (7, 8),
                                  (1000, 20), (4096, 12)])
def test_slices_cover_the_rows_and_stay_within_a_pass(hw, c):
    s = gn_ops.num_slices(hw, c)
    rows_per_pass = gn_ops.THREADS // (c // gn_ops.vec_width(c))
    per = -(-hw // s)
    assert 1 <= s <= -(-hw // rows_per_pass) and s * per >= hw and (s - 1) * per < hw
