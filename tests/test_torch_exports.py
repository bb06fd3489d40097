"""The port's export surface against the JAX package's.

Every public name of every subpackage of ``hvs_tpu`` (its ``__all__``) has
either the same name in the port's package or an entry in ``OTHER_FORMS``:
the port's counterpart under another form (imported here, so a renamed or
removed counterpart fails), or a reason it is not ported, from ROADMAP's
"Not queued" list. The root's public names and subpackages likewise.
"""

import importlib
import importlib.util

import pytest

# JAX name -> (port package, dotted path of the counterpart in it, why).
OTHER_FORMS = {
    "hvs_tpu.training": {
        "make_optimizer": ("training.optimizer.ManifoldAwareOptimizer",
                           "the optax chain as an optimizer over named torch parameters"),
        "mhc_partition": ("training.optimizer.partition_label",
                          "the label of one parameter path, not a label tree"),
        "tangent_precondition": ("ops.manifold.birkhoff_tangent_project",
                                 "applied to square H_res_raw gradients inside "
                                 "ManifoldAwareOptimizer.update"),
        "periodic_sinkhorn_projection": ("training.optimizer.ManifoldAwareOptimizer.update",
                                         "its project_every projection step"),
        "make_train_step": ("training.trainer.train_step", "a function, not a step factory"),
        "make_eval_step": ("training.trainer.eval_step", "a function, not a step factory"),
        "make_train_chunk": ("training.chunk.TrainChunk",
                             "a captured CUDA graph of the step, not a scanned jit"),
        "make_val_chunk": ("training.chunk.ValChunk",
                           "a captured CUDA graph of the validation pass"),
    },
    "hvs_tpu.config": {
        "detect_device": ("device.resolve_device",
                          "raises without a card rather than answering 'cpu'"),
    },
    "hvs_tpu.data": {
        "sample_batch": ("data.device_pipeline.draw_augment",
                         "draw_augment draws the batch, apply_augment gathers and warps it"),
    },
    "hvs_tpu.parallel": {
        "batch_sharding": ("parallel.mesh.shard_batch",
                           "a process takes its rows of the batch; no sharding object"),
        "replicated": ("parallel.mesh.shard_batch",
                       "each process holds the whole model; only the batch is split"),
    },
}
# Not ported, with ROADMAP's reason ("Not queued"); none is in these packages'
# __all__ today, and a name listed here must not have a port name.
NOT_QUEUED = {
    "savedmodel": "jax2tf export; a torch -> TF path would need ONNX",
    "aot": "a CUDA graph does not persist across processes; the .pt2 program does",
    "compile": "ModelProfiler.compile and the compile cache have no counterpart outside XLA",
    "enable_compile_cache": "JAX's persistent compilation cache has no counterpart outside XLA",
}
# JAX subpackages the port has under another form.
OTHER_SUBPACKAGES = {
    "native": ("ops.nms.batched_nms",
               "the C++ host helpers (letterbox, greedy NMS, IoU) are torch code on the card "
               "(ops/nms.py, ops/boxes.py, inference/preprocessing.py); the tests keep "
               "JAX's greedy NMS as their oracle"),
}

PACKAGES = ["models", "ops", "training", "config", "data", "deployment", "inference",
            "parallel", "utils"]


def _resolve(dotted: str):
    module, _, rest = dotted.partition(".")
    obj = importlib.import_module(f"hvs_tpu_torch.{module}")
    parts = rest.split(".")
    for i, part in enumerate(parts):
        if not hasattr(obj, part):
            obj = importlib.import_module(f"{obj.__name__}.{part}")
        else:
            obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("package", PACKAGES)
def test_every_public_jax_name_has_a_port_counterpart(package):
    jax_mod = importlib.import_module(f"hvs_tpu.{package}")
    port_mod = importlib.import_module(f"hvs_tpu_torch.{package}")
    other = OTHER_FORMS.get(f"hvs_tpu.{package}", {})
    missing = []
    for name in jax_mod.__all__:
        if name in other:
            assert not hasattr(port_mod, name), f"{name} is ported: drop its OTHER_FORMS entry"
            assert _resolve(other[name][0]) is not None
        elif name in NOT_QUEUED:
            assert not hasattr(port_mod, name)
        elif name not in port_mod.__all__ or not hasattr(port_mod, name):
            missing.append(name)
    assert not missing, f"hvs_tpu.{package} names with no port counterpart: {missing}"


@pytest.mark.parametrize("package", PACKAGES)
def test_port_all_names_exist_and_kinds_match(package):
    """Every name the port exports exists, and a JAX class is a port class
    (a JAX function a port callable) of the same name."""
    jax_mod = importlib.import_module(f"hvs_tpu.{package}")
    port_mod = importlib.import_module(f"hvs_tpu_torch.{package}")
    for name in port_mod.__all__:
        assert hasattr(port_mod, name), name
    for name in set(jax_mod.__all__) & set(port_mod.__all__):
        j, p = getattr(jax_mod, name), getattr(port_mod, name)
        if isinstance(j, type):
            assert isinstance(p, type), name
        elif callable(j):
            assert callable(p), name


def test_other_forms_name_only_jax_exports():
    for package, entries in OTHER_FORMS.items():
        assert set(entries) <= set(importlib.import_module(package).__all__)


def test_root_names_and_subpackages_have_port_counterparts():
    import pkgutil

    import hvs_tpu
    import hvs_tpu_torch

    public = [n for n in vars(hvs_tpu) if not n.startswith("_") or n == "__version__"]
    public = [n for n in public if not hasattr(getattr(hvs_tpu, n), "__path__")
              and not type(getattr(hvs_tpu, n)).__name__ == "module"]
    assert "__version__" in public
    for name in public:
        assert hasattr(hvs_tpu_torch, name), name
    assert hvs_tpu_torch.__version__ == hvs_tpu.__version__
    for sub in pkgutil.iter_modules(hvs_tpu.__path__):
        if not sub.ispkg:
            continue
        if sub.name in OTHER_SUBPACKAGES:
            assert _resolve(OTHER_SUBPACKAGES[sub.name][0]) is not None
        else:
            assert importlib.util.find_spec(f"hvs_tpu_torch.{sub.name}") is not None, sub.name
    assert set(OTHER_SUBPACKAGES) <= {m.name for m in pkgutil.iter_modules(hvs_tpu.__path__)}
