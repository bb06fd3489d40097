"""The port's ``ModelConfig`` from a configuration file
(``harness/program.py::model_config``): from the hybrid's flat keys, or from
a ``model`` block that states the dataclass's fields itself, every key held
to a field."""

import pytest

from conftest import load_config, tiny_config
from perfbench.harness import program

# The two files restated as ``model`` blocks, field for field what their
# flat keys state.
BLOCKS = {
    "hvs_flagship": {
        "feature_dim": 256,
        "mhc": {"sinkhorn_iterations": 20},
        "backbone": {"base_channels": 32, "stage_blocks": [2, 3, 4, 2],
                     "stage_channels": [64, 128, 256, 512]},
        "vit": {"enabled": True, "dim": 256, "depth": 6, "num_heads": 8},
        "fusion": {"fpn_channels": 256, "out_channels": [256, 512, 1024]},
        "detection": {"num_classes": 80, "num_anchors": 3, "head_channels": 256},
    },
    "hvs_lightweight": {
        "feature_dim": 256,
        "mhc": {"sinkhorn_iterations": 20},
        "backbone": {"base_channels": 32, "stage_blocks": [1, 2, 2, 1],
                     "stage_channels": [48, 96, 192, 384]},
        "vit": {"enabled": False, "dim": 256, "depth": 6, "num_heads": 8},
        "fusion": {"fpn_channels": 128, "out_channels": [256, 512, 1024]},
        "detection": {"num_classes": 80, "num_anchors": 3, "head_channels": 128},
    },
}

# ``conftest.tiny_config()`` as a block.
TINY_BLOCK = {
    "feature_dim": 32,
    "mhc": {"sinkhorn_iterations": 5},
    "backbone": {"base_channels": 8, "stage_blocks": [1, 2, 1, 1],
                 "stage_channels": [16, 32, 32, 64]},
    "vit": {"enabled": True, "dim": 32, "depth": 1, "num_heads": 2},
    "fusion": {"fpn_channels": 32, "out_channels": [256, 512, 1024]},
    "detection": {"num_classes": 6, "num_anchors": 3, "head_channels": 32},
}


def flat_model_config(cfg, device):
    """The mapping from the flat keys as it was before the ``model`` block:
    the fixed reference that the files' configurations are held to."""
    from hvs_tpu_torch.config.model import ModelConfig

    return ModelConfig(
        device=device, precision=cfg["dtype"], feature_dim=cfg["feature_dim"],
        mhc={"sinkhorn_iterations": cfg["sinkhorn_iterations"]},
        backbone={"base_channels": cfg["base_channels"],
                  "stage_blocks": tuple(cfg["stage_blocks"]),
                  "stage_channels": tuple(cfg["stage_channels"])},
        vit={"enabled": cfg["use_vit"], "dim": cfg["vit_dim"], "depth": cfg["vit_depth"],
             "num_heads": cfg["vit_heads"]},
        fusion={"fpn_channels": cfg["fpn_channels"],
                "out_channels": tuple(cfg["fusion_out_channels"])},
        detection={"num_classes": cfg["num_classes"], "num_anchors": cfg["num_anchors"],
                   "head_channels": cfg["head_channels"]})


def shapes(model_cfg, **kw):
    """Parameter shapes by name of the model built as the engine builds it."""
    model = model_cfg.build_model(production=True, device="cpu", **kw)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", ["hvs_flagship", "hvs_lightweight"])
def test_flat_keys_build_what_they_built(name):
    cfg = load_config(name)
    assert "model" not in cfg
    assert program.model_config(cfg, "cpu") == flat_model_config(cfg, "cpu")


@pytest.mark.parametrize("name", ["hvs_flagship", "hvs_lightweight"])
def test_a_model_block_restating_the_flat_keys_builds_the_same_model(name):
    cfg = load_config(name)
    flat = program.model_config(cfg, "cpu")
    block = program.model_config({**cfg, "model": BLOCKS[name]}, "cpu")
    assert block == flat
    assert isinstance(block.backbone.stage_blocks, tuple)
    assert isinstance(block.fusion.out_channels, tuple)
    assert shapes(block) == shapes(flat)


def test_the_block_states_what_the_flat_keys_cannot():
    """``rag.enabled`` (the retrieval model) and ``use_segmentation`` (with
    a task that builds its head) change the built model's parameters."""
    cfg = {**tiny_config(), "model": TINY_BLOCK}
    plain = program.model_config(cfg, "cpu")
    assert plain == flat_model_config(tiny_config(), "cpu")
    rag = program.model_config(
        {**cfg, "model": {**TINY_BLOCK, "rag": {"enabled": True,
                                                "class_names": ["person", "car", "dog"]}}},
        "cpu")
    assert rag.rag.enabled and rag.rag.class_names == ("person", "car", "dog")
    base, with_rag = shapes(plain), shapes(rag)
    assert set(base) < set(with_rag)
    assert "rag_gate" in with_rag
    seg = program.model_config({**cfg, "model": {**TINY_BLOCK, "use_segmentation": True}}, "cpu")
    assert set(shapes(plain, task="multi_task")) < set(shapes(seg, task="multi_task"))


@pytest.mark.parametrize("block, key", [
    ({**TINY_BLOCK, "use_segmentaton": True}, "use_segmentaton"),
    ({**TINY_BLOCK, "backbone": {**TINY_BLOCK["backbone"], "stage_chanels": [16, 32, 32, 64]}},
     "backbone.stage_chanels"),
    ({**TINY_BLOCK, "rag": {"enabled": True, "topk": 3}}, "rag.topk"),
    ({**TINY_BLOCK, "mhc": 5}, "mhc"),
    ({**TINY_BLOCK, "device": "cpu"}, "device"),
    ({**TINY_BLOCK, "precision": "fp32"}, "precision"),
], ids=["top_level", "nested", "nested_rag", "not_an_object", "device", "precision"])
def test_a_key_the_port_does_not_take_raises_with_its_dotted_name(block, key):
    with pytest.raises(ValueError, match=f"'{key}'"):
        program.model_config({**tiny_config(), "model": block}, "cpu")
