"""The certificate's boundary stress case through the port's batched
engine, shared by the CPU test (tests/test_torch_host.py) and the card
test (tests/test_torch_cuda.py). Not a test module: it imports only the
port, so the card tests can run without jax.
"""

import numpy as np

from hvq_tpu_torch.models.batched import BatchedEngine
from hvq_tpu_torch.models.oracle import search_oracle
from hvq_tpu_torch.ops import kernels
from hvq_tpu_torch.utils.compare import recall_at_k
from hvq_tpu_torch.utils.formats import Dataset, QuerySet
from hvq_tpu_torch.utils.generators import generate_dataset, generate_queries

# The lane kernel each lane scan_impl launches.
LANE_KERNEL = {"v1": "packed_scan", "v2": "packed_scan_v2"}


def certificate_stress(device, scan_store: str, scale: float,
                       scan_impl: str = "v3") -> dict:
    """The port of tests/test_certificate.py::
    test_certificate_slack_boundary_stress through the port's
    ``BatchedEngine(scan_impl=...)``: large-norm vectors maximise the
    selection product's absolute error, and 64 rows on a near-exact sphere
    around query 0 put ties at the k-th distance far inside the slack band.
    The result must stay oracle-exact at every scale: either the scan got
    it right or the certificate flagged it and the ladder repaired it. The
    bin depth is the main path's (R = 3 for K1, "v3"; R = 4 for K3 "v1" and
    K2 "v2"; rung 1 at 2R), so on the card the kernel's tensor-core body is
    what the certificate is held to; the engine's own choice at 16384 rows
    (R > 8) would run its CUDA-core body. Returns the engine kernel's
    launches per body and the ladder's counts."""
    ds = generate_dataset(16384, seed=33, categories=20)
    qs = generate_queries(8, seed=34, categories=20, types=(0,))
    rng = np.random.default_rng(35)
    V = (ds.V * scale).astype(np.float32)
    qV = (qs.V * scale).astype(np.float32)
    dirs = rng.standard_normal((64, V.shape[1])).astype(np.float64)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radius = 0.1 * scale * (1.0 + 1e-7 * rng.standard_normal((64, 1)))
    V[:64] = (qV[0].astype(np.float64) + radius * dirs).astype(np.float32)
    ds = Dataset(C=ds.C, T=ds.T, V=V)
    qs = QuerySet(qtype=qs.qtype, v=qs.v, l=qs.l, r=qs.r, V=qV)
    eng = BatchedEngine(ds, query_batch=8, scan_impl=scan_impl, scan_store=scan_store,
                        bin_top=3 if scan_impl == "v3" else 4, device=device)
    kernels.reset_launches()
    ids, dists = eng.search(qs)
    bodies = (kernels.k1_body_launches if scan_impl == "v3" else
              kernels.lane_body_launches[LANE_KERNEL[scan_impl]])
    counts = dict(bodies, ladder=dict(eng.last_ladder))
    oids, odists = search_oracle(ds, qs)
    # The 0.002 tolerance is calibrated for unit-scale data; at scale s a
    # selection miss confuses a sphere row (d ≈ (0.1s)²) with a random row
    # (d ≈ ‖q‖²+‖d‖²), ~1e4× any fp noise: query 0's top-64 must be the sphere.
    assert set(ids[0][:64].tolist()) == set(range(64)), scale
    tol = max(0.002, 1e-5 * float(odists.max()))
    assert recall_at_k(ids, oids, dists, odists, tolerance=tol) == 1.0, scale
    return counts
