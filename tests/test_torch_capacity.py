"""The capacity leg of the port's dry run (``hvq_tpu_torch.entry.
_dryrun_capacity``, the counterpart of ``__graft_entry__._dryrun_capacity``)
on CPU shards, at a size that keeps its shape: many tiles a shard and
four paged windows, each step held to the float64 oracle."""

import pytest

from hvq_tpu_torch import entry


def test_capacity_leg_on_four_cpu_shards():
    out = entry._dryrun_capacity(4, "cpu", n=65536, m=8, db_tile=2048, window_rows=16384)
    assert out["shards"] == 4 and out["n"] == 65536
    assert out["tiles_per_shard"] >= 8 and out["windows"] == 4
    assert out["max_dist_diff_mesh"] <= 0.002 and out["max_dist_diff_paged"] <= 0.002


@pytest.mark.parametrize("env,runs", [(None, True), ("1", True), ("0", False)])
def test_dry_run_takes_the_capacity_leg_unless_told_not_to(monkeypatch, env, runs):
    calls = []
    monkeypatch.setattr(entry, "_dryrun_capacity",
                        lambda n, device: calls.append((n, device)) or {"n": 0})
    if env is None:
        monkeypatch.delenv("HVQ_DRYRUN_CAPACITY", raising=False)
    else:
        monkeypatch.setenv("HVQ_DRYRUN_CAPACITY", env)
    out = entry.dryrun_multichip(2, device="cpu")
    assert calls == ([(2, "cpu")] if runs else [])
    assert ("capacity" in out) == runs
