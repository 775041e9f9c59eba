"""The port's out-of-core baselines (``repro_torch.baselines``: PSW, after
GraphChi, and ESG, after X-Stream) on the CPU, held against the reference
package's on the same edges: sssp, bfs and cc values bitwise, PageRank to
``PR_RTOL`` (float32 sums, as ``test_torch_session.py``), the same
iteration count, and the same bytes read and written (``BytesCounter``:
the files are the reference's, byte for byte)."""
import numpy as np
import pytest
import torch

from repro.baselines.esg import ESGEngine as RefESG
from repro.baselines.psw import PSWEngine as RefPSW
from repro.core.apps import get_app as ref_get_app
from repro_torch.baselines import ESGEngine, PSWEngine
from repro_torch.core.apps import get_app

PR_RTOL = 5e-4
ENGINES = {"esg": (ESGEngine, RefESG), "psw": (PSWEngine, RefPSW)}
APPS = {"pagerank": dict(max_iters=10), "sssp": dict(source=3),
        "bfs": dict(source=0), "cc": {}}


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_baseline_matches_reference(small_graph, tmp_path, engine, app):
    src, dst, n = small_graph
    cls, ref_cls = ENGINES[engine]
    kw = dict(APPS[app])
    max_iters = kw.pop("max_iters", 100)
    got_eng = cls(str(tmp_path / "port"), src, dst, n, device="cpu")
    want_eng = ref_cls(str(tmp_path / "ref"), src, dst, n)
    got, got_it, _ = got_eng.run(get_app(app, **kw), max_iters=max_iters)
    want, want_it, _ = want_eng.run(ref_get_app(app, **kw),
                                    max_iters=max_iters)
    assert got.dtype == want.dtype == np.float32
    assert got_it == want_it
    if app == "pagerank":
        np.testing.assert_allclose(got, want, rtol=PR_RTOL)
    else:
        np.testing.assert_array_equal(got, want)
        assert np.isfinite(got).sum() > 1  # the run reached past its source
    assert (got_eng.io.read, got_eng.io.written) == \
        (want_eng.io.read, want_eng.io.written)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_baseline_defaults_to_the_card(small_graph, tmp_path, engine):
    """As ``GraphSession``: ``device="cuda"`` unless the caller asks for the
    CPU, and no GPU means an error, not a quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    src, dst, n = small_graph
    with pytest.raises(RuntimeError, match="cuda"):
        ENGINES[engine][0](str(tmp_path), src, dst, n)
