"""The port's export surface against the JAX package's.

Every public name of ``hvs_tpu.models``, ``hvs_tpu.ops`` and
``hvs_tpu.training`` (their ``__all__``) has either the same name in the
port's package or an entry in ``OTHER_FORMS``: the port's counterpart under
another form (imported here, so a renamed or removed counterpart fails), or a
reason it is not ported, from ROADMAP's "Not queued" list.
"""

import importlib

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
}
# Not ported, with ROADMAP's reason ("Not queued"); none is in these packages'
# __all__ today, and a name listed here must not have a port name.
NOT_QUEUED = {
    "savedmodel": "jax2tf export; a torch -> TF path would need ONNX",
    "aot": "a CUDA graph does not persist across processes; the .pt2 program does",
    "compile": "ModelProfiler.compile and the compile cache have no counterpart outside XLA",
}

PACKAGES = ["models", "ops", "training"]


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
