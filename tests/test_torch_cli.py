"""The port's CLI on the CPU, called in process (``cli.main.main``): the
run.sh differential flow through ``python -m hvq_tpu_torch.cli``.

``gen-data`` and ``gen-queries`` must write files byte-identical to the
JAX CLI's; ``run`` of the exact engines and the oracle must ``compare``
"same" or "similar" (0.002); ``compare`` must catch a corrupted distance.
"""

import functools

import numpy as np
import pytest
import torch

from hvq_tpu.cli.main import main as jax_main
from hvq_tpu_torch.cli.main import main
from hvq_tpu_torch.models import paged
from hvq_tpu_torch.utils import formats


def run(tmp, *argv):
    return main(["run", "--data", str(tmp / "data.bin"), "--queries",
                 str(tmp / "query.bin"), *argv])


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    assert main(["gen-data", str(d / "data.bin"), "1500", "--categories", "30",
                 "--seed", "5"]) == 0
    assert main(["gen-queries", str(d / "query.bin"), "24", "--categories", "30",
                 "--seed", "6"]) == 0
    assert run(d, "--engine", "oracle", "--device", "cpu",
               "--output", str(d / "oracle.bin")) == 0
    return d


@pytest.mark.parametrize("cmd,argv", [
    ("gen-data", ["1500", "--categories", "30", "--seed", "5"]),
    ("gen-data", ["777"]),
    ("gen-queries", ["24", "--categories", "30", "--seed", "6"]),
    ("gen-queries", ["13", "--seed", "2"]),
])
def test_generated_files_are_byte_identical_to_the_jax_cli(tmp_path, cmd, argv):
    assert main([cmd, str(tmp_path / "torch.bin"), *argv]) == 0
    assert jax_main([cmd, str(tmp_path / "jax.bin"), *argv]) == 0
    assert (tmp_path / "torch.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


def test_run_and_compare_the_exact_engines(workdir, capsys):
    outs = [str(workdir / "oracle.bin")]
    for engine, extra in (
        ("batched", ["--db-tile", "256", "--query-batch", "8"]),
        ("partitioned", ["--db-tile", "256", "--query-batch", "8"]),
        ("paged", ["--db-tile", "256", "--query-batch", "8",
                   "--engine-opt", "window_rows=512"]),
    ):
        out = str(workdir / f"{engine}.bin")
        assert run(workdir, "--engine", engine, "--device", "cpu", "--output", out,
                   *extra) == 0
        assert "search:" in capsys.readouterr().err
        assert (workdir / f"{engine}.bin").stat().st_size == 24 * 100 * 4
        outs.append(out)
    capsys.readouterr()
    assert main(["compare", *outs]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 6 and all(("same" in s or "similar" in s) for s in lines)


def test_compare_detects_corruption(workdir, capsys):
    d = formats.read_dist(workdir / "oracle.bin.dist")
    raw = (workdir / "oracle.bin.dist").read_bytes()
    payload = np.frombuffer(raw[4:], np.float32).copy()
    payload[7] += 5.0
    (workdir / "bad.dist").write_bytes(raw[:4] + payload.tobytes())
    assert d.shape == (24, 100)
    capsys.readouterr()
    assert main(["compare", str(workdir / "oracle.bin.dist"), str(workdir / "bad.dist")]) == 2
    out = capsys.readouterr().out
    assert "different" in out and "query 0 rank 7" in out


def test_engine_opt_passthrough(workdir, monkeypatch, capsys):
    """KEY=VALUE reaches the constructor as int, float or str; a key the
    engine does not take warns and is dropped."""
    seen = {}
    init = paged.PagedEngine.__init__

    @functools.wraps(init)
    def spy(self, ds, **kw):
        seen.update(kw)
        init(self, ds, **kw)

    monkeypatch.setattr(paged.PagedEngine, "__init__", spy)
    assert run(workdir, "--engine", "paged", "--device", "cpu", "--query-batch", "8",
               "--engine-opt", "window_rows=768", "--engine-opt", "hbm_budget_bytes=1.5e6",
               "--engine-opt", "scan_impl=stream", "--engine-opt", "bogus=1",
               "--output", str(workdir / "opt.bin")) == 0
    assert seen["window_rows"] == 768 and seen["hbm_budget_bytes"] == 1.5e6
    assert seen["scan_impl"] == "stream" and "bogus" not in seen
    assert seen["query_batch"] == 8 and seen["device"] == "cpu"
    assert "paged ignores --engine-opt bogus" in capsys.readouterr().err


@pytest.mark.parametrize("kind,engine,extra", [
    ("partitioned", "partitioned", ["--query-batch", "8"]),
    ("ivf", "ivf", ["--query-batch", "8", "--engine-opt", "nprobe=4"]),
])
def test_build_index_and_run_with_it(workdir, capsys, kind, engine, extra):
    idx = workdir / f"{kind}.npz"
    build = ["--db-tile", "256"] if kind == "partitioned" else ["--cap", "128",
                                                               "--kmeans-iters", "2"]
    assert main(["build-index", "--data", str(workdir / "data.bin"), "--kind", kind,
                 "--out", str(idx), "--device", "cpu", *build]) == 0
    assert idx.exists()
    out = str(workdir / f"{kind}_idx.bin")
    assert run(workdir, "--engine", engine, "--device", "cpu", "--index", str(idx),
               "--output", out, *extra) == 0
    assert "load_index" in capsys.readouterr().err
    if kind == "partitioned":
        assert main(["compare", str(workdir / "oracle.bin"), out]) == 0
        assert "different" not in capsys.readouterr().out


def test_profile_writes_a_trace(workdir, tmp_path, capsys):
    trace = tmp_path / "trace"
    assert run(workdir, "--engine", "batched", "--device", "cpu", "--db-tile", "256",
               "--query-batch", "8", "--profile", str(trace),
               "--output", str(workdir / "prof.bin")) == 0
    assert (trace / "trace.json").stat().st_size > 0


def test_resilient_run(workdir, capsys):
    out = str(workdir / "res.bin")
    assert run(workdir, "--engine", "paged", "--device", "cpu", "--resilient",
               "--db-tile", "256", "--query-batch", "8",
               "--engine-opt", "window_rows=512", "--output", out) == 0
    assert main(["compare", str(workdir / "oracle.bin"), out]) == 0


def test_run_defaults_to_cuda_and_raises_without_a_card(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(workdir, "--engine", "batched", "--output", str(workdir / "x.bin"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["build-index", "--data", str(workdir / "data.bin"), "--kind", "ivf",
              "--out", str(workdir / "x.npz")])
