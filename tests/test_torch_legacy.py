"""The reference's deprecated surfaces in the port: ``VSWEngine``'s old
keyword signature (a cache mode in the third place, ``cache_mode=``,
``use_pallas=`` and the rest of ``_LEGACY_KWARGS``), the ``apps.APPS``
alias of the live registry, and the package's ``__all__``.

Each shim is held against the reference's on the conftest store: the same
``DeprecationWarning``, the same ``TypeError``, the same resulting
``EngineConfig`` field by field (``use_pallas`` against ``use_kernel``) and
the same cc values.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import apps as ref_apps
from repro.core.engine import VSWEngine as RefEngine
from repro_torch.core import apps
from repro_torch.core.engine import _LEGACY_KWARGS, EngineConfig, VSWEngine
from repro_torch.graph.storage import GraphStore
from repro_torch.session import GraphSession


@pytest.fixture(scope="module")
def stores(graph_store):
    """(the port's, the reference's) view of the conftest store."""
    return GraphStore(str(graph_store.path)), graph_store


def _build(cls, store, prog, args, kwargs):
    """-> (engine or the TypeError raised, the DeprecationWarnings' texts)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            eng = cls(store, prog, *args, **kwargs)
        except TypeError as exc:
            eng = exc
    return eng, [str(w.message) for w in caught
                 if issubclass(w.category, DeprecationWarning)]


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    if "use_pallas" in out:
        out["use_kernel"] = out.pop("use_pallas")
    return out


def test_legacy_kwargs_are_the_references():
    from repro.core.engine import _LEGACY_KWARGS as ref_legacy
    assert _LEGACY_KWARGS == ref_legacy


def test_legacy_engine_shim_still_works(stores):
    """The pre-session VSWEngine kwarg signature warns but still runs."""
    store, _ = stores
    with pytest.warns(DeprecationWarning, match="EngineConfig"):
        eng = VSWEngine(store, apps.cc(), cache_mode=1,
                        cache_budget_bytes=1 << 24, device="cpu")
    res = eng.run(max_iters=50)
    with GraphSession(str(store.path), cache_mode=0, device="cpu") as s:
        base = s.run("cc", max_iters=50)
    np.testing.assert_array_equal(res.values, base.values)


@pytest.mark.parametrize("args,kwargs", [
    ((1,), {}),
    (("auto",), {}),
    ((), {"cache_mode": 1, "use_pallas": False}),
    ((), {"cache_mode": 2, "cache_budget_bytes": 1 << 24,
          "selective_threshold": 0.01, "preload": True,
          "prefetch_depth": 1}),
    ((3,), {"cache_budget_bytes": 1 << 20, "use_pallas": "auto"}),
], ids=["positional-int", "positional-str", "use_pallas", "all-names",
        "positional-and-kwargs"])
def test_legacy_signature_matches_reference(stores, args, kwargs):
    """The same warning, the same config and the same cc values as the
    reference's shim; ``use_pallas`` lands on ``use_kernel``."""
    store, ref_store = stores
    eng, said = _build(lambda *a, **k: VSWEngine(*a, device="cpu", **k),
                       store, apps.cc(), args, kwargs)
    ref, ref_said = _build(RefEngine, ref_store, ref_apps.cc(), args, kwargs)
    assert said == ref_said and len(said) == 1
    assert _fields(eng.config) == {"fused_gather": True,
                                   **_fields(ref.config)}
    if "use_pallas" in kwargs:
        assert eng.config.use_kernel == kwargs["use_pallas"]
    got, want = eng.run(max_iters=50), ref.run(max_iters=50)
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    assert got.iterations == want.iterations


@pytest.mark.parametrize("args,kwargs", [
    ((), {"bogus": 1}),
    ((1,), {"use_kernel": False, "zap": 2}),
    ((), {"cache_mode": 1, "num_devices": 2}),
])
def test_legacy_unknown_names_raise_as_reference(stores, args, kwargs):
    store, ref_store = stores
    err, said = _build(lambda *a, **k: VSWEngine(*a, device="cpu", **k),
                       store, apps.cc(), args, kwargs)
    ref_err, ref_said = _build(RefEngine, ref_store, ref_apps.cc(), args,
                               kwargs)
    assert isinstance(err, TypeError) and isinstance(ref_err, TypeError)
    assert str(err) == str(ref_err)
    assert str(err).startswith("unexpected VSWEngine arguments: [")
    assert said == ref_said == []


def test_config_object_takes_no_warning(stores):
    """An ``EngineConfig`` in the third place is the current signature."""
    store, _ = stores
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        eng = VSWEngine(store, apps.cc(), EngineConfig(cache_mode=2),
                        device="cpu")
    assert eng.config == EngineConfig(cache_mode=2)


def test_legacy_shim_still_needs_cuda_by_default(stores):
    """The shim opens no way to the CPU: without ``device=`` the engine
    wants a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    store, _ = stores
    with pytest.warns(DeprecationWarning), \
            pytest.raises(RuntimeError, match="cuda"):
        VSWEngine(store, apps.cc(), 1)


def test_apps_alias_is_the_live_registry():
    assert apps.APPS is apps._REGISTRY
    assert apps.APPS["pagerank"] is apps.pagerank
    assert set(apps.APPS) == set(ref_apps.APPS)

    @apps.register_app(name="legacy_alias_probe")
    def probe():
        return apps.cc()

    try:
        assert apps.APPS["legacy_alias_probe"] is probe
        assert "legacy_alias_probe" in apps.available_apps()
    finally:
        del apps.APPS["legacy_alias_probe"]
    assert "legacy_alias_probe" not in apps.available_apps()


def test_all_is_the_references():
    assert repro_torch.__all__ == repro.__all__
    ns: dict = {}
    exec("from repro_torch import *", ns)
    assert sorted(k for k in ns if k != "__builtins__") == repro.__all__
