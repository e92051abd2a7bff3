"""The TPU probe kernels' plain versions against the experiments' own Pallas
kernels, and their wrappers, tools and bounds on the CPU.

``experiments/v3_anatomy.py``, ``int8_probe.py`` and ``pallas_probe.py`` are
loaded from their paths as they are (sizes through their ``V3A_*``
variables or module constants) and their kernels run in TPU interpret mode
on the CPU, on the same numpy inputs as the port's plain versions
(``hvq_tpu_torch/ops/probe_kernels.py``). Tolerances: int8 equal; bf16 and
fp32 products within the fp32 summation slack of each entry,
(128 + 4)·2⁻²⁴·Σ|q_k·d_k| (twice that in a distance, plus an ulp of the
sum; one bf16 ulp more after mmb's rounding); the packed stages one key
quantum plus the fp32-plane selection slack (``utils.check.scan_agreement``),
on every plane: the CPU's XLA may fuse a rounding away.
"""

import importlib.util
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hvq_tpu_torch.ops import kernels, probe_kernels
from hvq_tpu_torch.ops.masks import query_predicate_fields
from hvq_tpu_torch.ops.scan import decode_keys
from hvq_tpu_torch.tools import int8_probe, pallas_probe, v3_anatomy
from hvq_tpu_torch.utils.check import scan_agreement

REPO = Path(__file__).resolve().parent.parent
REL_MM = 1.6e-5
# The anatomy's small shape: B 64 in one block, two tiles of 1024 rows.
A_B, A_DT, A_NT = 64, 1024, 2


def _load(name: str, env: dict | None = None):
    """experiments/<name>.py as a module, unedited; the jax compilation
    cache it sets at import is put back."""
    env = env or {}
    cache = jax.config.values.get("jax_compilation_cache_dir")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        spec = importlib.util.spec_from_file_location(
            f"experiments_{name}", REPO / "experiments" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


@pytest.fixture(scope="module")
def anatomy():
    return _load("v3_anatomy", dict(V3A_B=str(A_B), V3A_G="1", V3A_DT=str(A_DT),
                                    V3A_NT=str(A_NT), V3A_BB=str(A_B), V3A_REPS="1"))


@pytest.fixture(scope="module")
def anatomy_data():
    """Rows and queries as the script draws them (normal in 128 lanes), a
    few categories so C == v matches, a sample limit, and bin 3 of tile 1
    with every row past it (its oid raised)."""
    rng = np.random.default_rng(5)
    n = A_NT * A_DT
    Vp = rng.standard_normal((n, 128)).astype(np.float32)
    C = rng.integers(0, 4, n).astype(np.float32)
    T = rng.uniform(-3, 3, n).astype(np.float32)
    oid = np.arange(n, dtype=np.int32)
    oid[A_DT + 8 * np.arange(128) + 3] += n
    qV = rng.standard_normal((A_B, 128)).astype(np.float32)
    qtype = rng.integers(0, 4, A_B)
    v = rng.integers(0, 4, A_B).astype(np.float32)
    l = rng.uniform(-3, 0, A_B).astype(np.float32)
    r = rng.uniform(0, 3, A_B).astype(np.float32)
    return dict(Vp=Vp, C=C, T=T, dn=(Vp * Vp).sum(1), oid=oid, qV=qV, qtype=qtype,
                v=v, l=l, r=r, sn=n - 100)


def _planes(Vp):
    """(JAX plane, script's plane flag, port plane) per plane name, both
    quantized as v3_anatomy.py:237 and ops/probe_kernels.py do."""
    Vi8 = jnp.clip(jnp.round(jnp.asarray(Vp) * (127.0 / 6.0)), -127, 127).astype(jnp.int8)
    Vt = torch.from_numpy(Vp)
    return {"fp32": (jnp.asarray(Vp), False, Vt),
            "bf16": (jnp.asarray(Vp).astype(jnp.bfloat16), True, Vt.to(torch.bfloat16)),
            "int8": (Vi8, "int8", probe_kernels.quantize_i8(Vt))}


def _jax_anatomy(mod, stage, R, plane, Vsel, d, qn):
    """The script's ``scan`` (v3_anatomy.py:148-199) returning its output,
    not its sum, with ``qn`` given (the port's, so both kernels see the
    same query norms)."""
    B, DT, NT, BB = mod.B, mod.DT, mod.NT, mod.BB
    bins = DT // mod.BIN
    out_w = R * bins
    qf32 = jnp.asarray(d["qV"])
    if plane == "int8":
        qhi = jnp.clip(jnp.round(qf32 * (127.0 / 6.0)), -127, 127).astype(jnp.int8)
        qlo = jnp.zeros_like(qhi)
    else:
        qhi = qf32.astype(jnp.bfloat16)
        qlo = (qf32 - qhi.astype(jnp.float32)).astype(jnp.bfloat16)
    qt = np.asarray(d["qtype"])
    ac, at = (qt == 1) | (qt == 3), (qt == 2) | (qt == 3)
    tile_row = lambda i, b, *_: (i, 0)
    tile_col = lambda i, b, *_: (0, i)
    qrow = lambda i, b, *_: (b, 0)
    out_ix = lambda i, b, *_: (b, i)
    vm = dict(memory_space=pltpu.VMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(NT, B // BB),
        in_specs=[pl.BlockSpec((DT, 128), tile_row, **vm)]
        + [pl.BlockSpec((1, DT), tile_col, **vm)] * 4
        + [pl.BlockSpec((BB, 128), qrow, **vm)] * 2
        + [pl.BlockSpec((BB, 1), qrow, **vm)] * 6,
        out_specs=[pl.BlockSpec((BB, out_w), out_ix, **vm)])
    with pltpu.force_tpu_interpret_mode():
        (out,) = pl.pallas_call(
            mod.make_kernel(stage, R, plane), grid_spec=grid_spec,
            out_shape=[jax.ShapeDtypeStruct((B, NT * out_w), jnp.int32)],
        )(jnp.asarray(d["sn"], jnp.int32).reshape(1), Vsel,
          jnp.asarray(d["C"]).reshape(1, -1), jnp.asarray(d["T"]).reshape(1, -1),
          jnp.asarray(d["dn"]).reshape(1, -1), jnp.asarray(d["oid"]).reshape(1, -1),
          qhi, qlo, jnp.asarray(qn).reshape(B, 1),
          jnp.asarray(ac.astype(np.int32)).reshape(B, 1), jnp.asarray(d["v"]).reshape(B, 1),
          jnp.asarray(at.astype(np.int32)).reshape(B, 1), jnp.asarray(d["l"]).reshape(B, 1),
          jnp.asarray(d["r"]).reshape(B, 1))
    return np.asarray(out)


def _port_args(d, Vs):
    t = torch.from_numpy
    fields = query_predicate_fields(t(d["qtype"]), t(d["v"]), t(d["l"]), t(d["r"]))
    return (Vs, t(d["C"]), t(d["T"]), t(d["dn"]), t(d["oid"]), t(d["qV"]), *fields, d["sn"])


# The script's stages before pack write their zeros past entry 0 with a
# scalar store that interpret mode refuses at R > 1 (it runs them at R 1
# only); the port's R > 1 there is held to its own R 1 below.
ANATOMY_CASES = [("full", 2, "fp32"), ("full", 2, "bf16"), ("full", 2, "int8"),
                 ("full", 3, "fp32"), ("full", 4, "int8"), ("full", 1, "bf16"),
                 ("mm", 1, "fp32"), ("mm", 1, "bf16"), ("mm", 1, "int8"),
                 ("dist", 1, "fp32"), ("dist", 1, "int8"),
                 ("mask", 1, "bf16"), ("mask", 1, "int8"), ("mask", 1, "fp32"),
                 ("pack", 2, "fp32"), ("pack", 2, "int8"),
                 ("mmb", 1, "bf16"), ("mmc512", 1, "bf16")]


@pytest.mark.parametrize("stage,R,plane", ANATOMY_CASES)
def test_anatomy_plain_matches_the_experiments_kernel(anatomy, anatomy_data, stage, R,
                                                      plane):
    d = anatomy_data
    Vsel, flag, Vs = _planes(d["Vp"])[plane]
    args = _port_args(d, Vs)
    got = probe_kernels.k1_anatomy_plain(*args, stage=stage, db_tile=A_DT, bin_top=R)
    qn = (args[5] * args[5]).sum(1).numpy()
    want = _jax_anatomy(anatomy, stage, R, flag, Vsel, d, qn)
    got = got.numpy()
    assert got.shape == want.shape == (A_B, A_NT * R * A_DT // 128)
    if plane == "int8" and stage == "mm":
        # the int8 product is exact, one fp32 rounding by ALPHA_I8 after it
        np.testing.assert_array_equal(got, want)
        return
    # (past mm, the CPU's XLA may contract q·d's rounding into an fma with
    # the distance's subtraction: an ulp of the distance, which the int8
    # plane shares with the others; on the card the kernel and the plain
    # version round alike and are held bit for bit)
    tile = A_DT if not stage.startswith("mmc") else int(stage[3:])
    if stage in ("pack", "full"):
        a = scan_agreement(*decode_keys(torch.from_numpy(got), tile, R),
                           *decode_keys(torch.from_numpy(want), tile, R), R, tile // 128,
                           torch.from_numpy(qn), float(d["dn"].max()), REL_MM)
        assert a["ok"], a
        return
    # min stages: entry 0 the min's bits, zeros after
    g4 = got.reshape(A_B, -1, R, tile // 128)
    w4 = want.reshape(A_B, -1, R, tile // 128)
    np.testing.assert_array_equal(g4[:, :, 1:], 0)
    np.testing.assert_array_equal(w4[:, :, 1:], 0)
    gv, wv = g4[:, :, 0].view(np.float32), w4[:, :, 0].view(np.float32)
    # Σ|q_k·d_k| of each row, its max over the bin's 128 rows
    S = np.abs(d["qV"]) @ np.abs(d["Vp"]).T                       # (B, rows)
    S = S.reshape(A_B, -1, 128, tile // 128).max(axis=2)
    tol = 132 * 2.0 ** -24 * S * (1 if stage.startswith("mm") else 2)
    tol = tol + np.abs(wv) * (2.0 ** -7 if stage == "mmb" else 2.0 ** -23)
    if stage in ("dist", "mask"):
        tol = tol + 2.0 ** -22 * (d["dn"].max() + qn[:, None, None])
    both_inf = np.isinf(gv) & np.isinf(wv)
    err = np.abs(np.where(both_inf, 0.0, gv).astype(np.float64) - np.where(both_inf, 0.0, wv))
    assert (err <= tol).all(), float((err - tol).max())


@pytest.mark.parametrize("stage", ["mm", "mmb", "dist", "mask"])
@pytest.mark.parametrize("plane", ["fp32", "int8"])
def test_anatomy_min_stages_at_deeper_R_pad_with_zeros(anatomy_data, stage, plane):
    """Before pack, R > 1 writes R 1's entry and zeros after it
    (v3_anatomy.py:69-74)."""
    d = anatomy_data
    args = _port_args(d, _planes(d["Vp"])[plane][2])
    one = probe_kernels.k1_anatomy_plain(*args, stage=stage, db_tile=A_DT, bin_top=1)
    four = probe_kernels.k1_anatomy_plain(*args, stage=stage, db_tile=A_DT, bin_top=4)
    four = four.view(A_B, A_NT, 4, A_DT // 128)
    assert torch.equal(four[:, :, 0].reshape(A_B, -1), one)
    assert not four[:, :, 1:].any()


def test_anatomy_masked_bin_pads_with_plus_inf_keys(anatomy_data):
    """Bin 3 of tile 1 has every row past the sample limit: the full
    stage's R entries there are 0x7F800000 (no payload), the key the
    script's removed slots carry (v3_anatomy.py:135-142)."""
    d = anatomy_data
    args = _port_args(d, torch.from_numpy(d["Vp"]))
    out = probe_kernels.k1_anatomy_plain(*args, stage="full", db_tile=A_DT, bin_top=3)
    bins = A_DT // 128
    col = 1 * 3 * bins + np.arange(3) * bins + 3
    assert bool((out[:, col] == 0x7F800000).all())


@pytest.fixture(scope="module")
def i8mod():
    return _load("int8_probe")


@pytest.mark.parametrize("variant", list(probe_kernels.INT8_PROBE_VARIANTS))
def test_int8_probe_plain_matches_the_experiments_kernel(i8mod, monkeypatch, variant):
    """At Dt = 16384 (the script's; its bins are (B, 128, Dt/128) groups,
    128 contiguous columns there), B 64, 2 tiles: the script's ``run`` (the
    kernel, then the min over tiles) against the plain version's."""
    b, nt, dt = 64, 2, 16384
    for name, val in (("B", b), ("Dt", dt), ("NT", nt)):
        monkeypatch.setattr(i8mod, name, val)
    rng = np.random.default_rng(9)
    io = {"bf16->f32": (jnp.bfloat16, jnp.float32, False),
          "int8->i32": (jnp.int8, jnp.int32, False),
          "int8->i32->f32": (jnp.int8, jnp.int32, True),
          "int8->f32": (jnp.int8, jnp.float32, False)}[variant]
    if io[0] == jnp.bfloat16:
        q = rng.standard_normal((b, 128)).astype(np.float32)
        dd = rng.standard_normal((nt, 128, dt)).astype(np.float32)
        qj, dj = jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(dd).astype(jnp.bfloat16)
        qt, dt_ = torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(dd).to(torch.bfloat16)
    else:
        q = rng.integers(-127, 127, (b, 128)).astype(np.int8)
        dd = rng.integers(-127, 127, (nt, 128, dt)).astype(np.int8)
        qj, dj, qt, dt_ = jnp.asarray(q), jnp.asarray(dd), torch.from_numpy(q), torch.from_numpy(dd)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(i8mod.make_mosaic(*io)(qj, dj))
    got = probe_kernels.int8_probe_plain(qt, dt_, variant).amin(0).numpy()
    assert got.shape == want.shape == (b, 128)
    assert got.dtype == want.dtype
    if variant.startswith("int8"):
        np.testing.assert_array_equal(got, want)
    else:
        qf, df = qt.float().numpy(), dt_.float().numpy()
        S = np.stack([(np.abs(qf) @ np.abs(df[t])).reshape(b, 128, 128).max(2)
                      for t in range(nt)]).max(0)
        assert (np.abs(got.astype(np.float64) - want) <= 128 * 2.0 ** -24 * S).all()


def test_trivial_plain_is_twice_x_bit_for_bit():
    pp = _load("pallas_probe")
    x = np.random.default_rng(3).standard_normal((256, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            pp._trivial, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32))(jnp.asarray(x)))
    got = probe_kernels.trivial(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got.numpy().view(np.int32), (2 * x).view(np.int32))


def test_probe_wrappers_run_their_plain_versions_on_the_cpu(anatomy_data):
    """CPU tensors: the plain version, no launch counted; a wrapper
    refuses what its kernel does not take."""
    probe_kernels.reset_launches()
    d = anatomy_data
    args = _port_args(d, torch.from_numpy(d["Vp"]))
    out = probe_kernels.k1_anatomy(*args, stage="mask", db_tile=A_DT, bin_top=2)
    assert torch.equal(out, probe_kernels.k1_anatomy_plain(*args, stage="mask",
                                                           db_tile=A_DT, bin_top=2))
    q = torch.randint(-127, 127, (8, 128), dtype=torch.int8)
    dd = torch.randint(-127, 127, (2, 128, 256), dtype=torch.int8)
    assert torch.equal(probe_kernels.int8_probe(q, dd, "int8->i32"),
                       probe_kernels.int8_probe_plain(q, dd, "int8->i32"))
    x = torch.randn(10)
    assert torch.equal(probe_kernels.trivial(x), x * 2)
    assert not probe_kernels.launches
    with pytest.raises(ValueError):
        probe_kernels.k1_anatomy(*args, stage="full", db_tile=A_DT, bin_top=5)
    with pytest.raises(ValueError):
        probe_kernels.k1_anatomy(*args, stage="mmc512", db_tile=A_DT, bin_top=2)
    Vi8 = probe_kernels.quantize_i8(torch.from_numpy(d["Vp"]))
    with pytest.raises(ValueError):
        probe_kernels.k1_anatomy(*_port_args(d, Vi8), stage="mmc512", db_tile=A_DT,
                                 bin_top=1)
    with pytest.raises(ValueError):
        probe_kernels.int8_probe(q, dd, "int8->i32", product=False)
    with pytest.raises(ValueError):
        probe_kernels.int8_probe(q.float(), dd, "int8->i32")


def test_the_cuda_constants_match_the_python_ones():
    """csrc/scan_wgmma.cuh's kAlphaI8 is fp32((6/127)²) and its Stage enum
    is STAGES in order."""
    src = kernels._HEADERS[0].read_text()
    alpha = re.search(r"kAlphaI8 = (0x[0-9a-fA-Fp.+-]+)f;", src).group(1)
    assert float.fromhex(alpha) == probe_kernels.ALPHA_I8
    assert probe_kernels.ALPHA_I8 == float(np.float32((6.0 / 127.0) ** 2))
    enum = re.search(r"enum Stage \{([^}]*)\}", src).group(1)
    names = [m.group(1).lower() for m in re.finditer(r"k(\w+) = \d+", enum)]
    values = [int(v) for v in re.findall(r"= (\d+)", enum)]
    assert names == list(probe_kernels.STAGES) and values == list(range(len(names)))


def test_the_tools_bounds_are_chip_smokes():
    """Each tool computes its own bound by the rule of chip_smoke's
    ``probe_bounds`` and agrees with it at the variants both price."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    pb = cs.probe_bounds()
    assert pallas_probe.trivial_bound() == pb["pallas_probe:32 _trivial"]
    assert int8_probe.probe_bound("bf16->f32") == pb["int8_probe:83 bf16"]
    for variant in ("int8->i32", "int8->i32->f32", "int8->f32"):
        assert int8_probe.probe_bound(variant) == pb["int8_probe:83 int8"]
    for plane in ("fp32", "bf16"):
        assert v3_anatomy.anatomy_bound("full", plane, R=2) == pb[f"v3_anatomy:189 {plane}"]
    # fewer bytes for the earlier stages, never more operations
    mm = v3_anatomy.anatomy_bound("mm", "int8")
    assert mm["bound_ms"] <= v3_anatomy.anatomy_bound("full", "int8", R=2)["bound_ms"]
    assert len(v3_anatomy.SPECS) == 15 and len(int8_probe.VARIANTS) == 4


def test_the_tools_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (v3_anatomy, int8_probe, pallas_probe):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["--out", os.devnull])


def test_sass_diff_matches_kernels_across_the_stage_argument():
    """tools/sass_diff pairs a kernel of this tree with the same kernel of
    an older tree whose shared body had no kStage argument: only the
    defaulted kFull = 5 is dropped, never another stage's."""
    from hvq_tpu_torch.tools.sass_diff import normalized

    old = ("void <unnamed>::scan_wgmma<<unnamed>::Axis1, (int)1, (int)64, (int)2, (int)3, "
           "(int)3>(CUtensorMap_st, <unnamed>::Args)")
    new = old.replace("(int)3>(", "(int)3, (int)5>(")
    assert normalized(new) == normalized(old) == old
    anatomy = new.replace("Axis1,", "Axis1Keys,").replace("(int)5>(", "(int)4>(")
    assert normalized(anatomy) == anatomy
    assert normalized("void <unnamed>::k1_simt<float>(<unnamed>::Args)") == \
        "void <unnamed>::k1_simt<float>(<unnamed>::Args)"


def test_sass_diff_drops_the_default_key_policy_and_the_old_lane_rr():
    """The shared body's key policy defaults to PackedKey (K1, K3, K2), which
    an older tree's names lack; K4's BinKey is kept. The CUDA-core lane
    kernel lost its RR argument; an older tree's RR = 0 kernels pair with
    this tree's, its RR > 0 ones (K4's register variants) do not."""
    from hvq_tpu_torch.tools.sass_diff import normalized

    old = ("void <unnamed>::scan_wgmma<<unnamed>::Lane, (int)6, (int)32, (int)2, (int)4, "
           "(int)3, (int)5>(CUtensorMap_st, <unnamed>::Args)")
    new = old.replace("(int)5>(", "(int)5, <unnamed>::PackedKey>(")
    k4 = old.replace("(int)5>(", "(int)5, <unnamed>::BinKey>(")
    assert normalized(new) == normalized(old)
    assert normalized(k4) == k4 != normalized(old)
    lane = "void <unnamed>::lane_scan_kernel<(int){}>(<unnamed>::LaneArgs)"
    assert normalized(lane.format("1, (int)0")) == lane.format(1) == normalized(lane.format(1))
    assert normalized(lane.format("2, (int)2")) == lane.format("2, (int)2")


def test_run_launches_on_the_current_stream_and_guards_only_another_device(monkeypatch):
    """kernels.run passes the current stream's handle of the tensor's device
    last, enters a device guard only when another device is current, and
    raises on a non-zero return (the card's calls, with the CUDA hooks
    replaced by recorders)."""
    entered = []

    class Guard:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(kernels, "_current_device", lambda: 0)
    monkeypatch.setattr(kernels, "_raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    calls = []
    fn = lambda *a: calls.append(a) or 0
    kernels.run("k", torch.device("cuda", 0), fn, 7, 8)
    kernels.run("k", torch.device("cuda"), fn)
    assert calls == [(7, 8, 1000), (1000,)] and entered == []
    kernels.run("k", torch.device("cuda", 1), fn, 9)
    assert calls[-1] == (9, 1001) and entered == [1]
    with pytest.raises(RuntimeError, match="cudaError 700"):
        kernels.run("k", torch.device("cuda", 0), lambda s: 700)
    with pytest.raises(RuntimeError, match="CUresult 1"):
        kernels.run("k", torch.device("cuda", 0), lambda s: -1)
