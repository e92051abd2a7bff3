#!/usr/bin/env bash
# Differential run harness of the PyTorch port, beside run.sh: run the
# oracle and every ported engine on the same D/Q through
# `python -m hvq_tpu_torch.cli`, then pairwise-compare the exact engines'
# .dist files under the 0.002 tolerance (reference run.sh:8-18). The exact
# engines (batched, partitioned, paged and the mesh engines sharded and
# partitioned_sharded, on the device's default mesh: every visible card, or
# one CPU shard) must come back "same"/"similar";
# ivf is approximate by design, so it gets a recall line against the
# oracle instead.
#
# Usage: [DEVICE=cuda|cpu] ./run_torch.sh [N] [M] [workdir]
set -euo pipefail

N="${1:-10000}"
M="${2:-100}"
DIR="${3:-./run_out}"
DEVICE="${DEVICE:-cuda}"
mkdir -p "$DIR/logs"

echo "== generating D=$N Q=$M (discretized C) =="
python -m hvq_tpu_torch.cli gen-data "$DIR/data.bin" "$N" --categories 100
python -m hvq_tpu_torch.cli gen-queries "$DIR/query.bin" "$M" --categories 100

# paged gets a window of N/2 rows (at least one 16384-row tile), so the
# host-paging path runs two windows once N reaches 32768.
for ENGINE in oracle batched partitioned paged sharded partitioned_sharded ivf; do
  EXTRA=()
  if [[ "$ENGINE" == "paged" ]]; then
    EXTRA=(--engine-opt "window_rows=$(( N / 2 ))")
  fi
  echo "== engine: $ENGINE on $DEVICE =="
  python -m hvq_tpu_torch.cli run \
    --data "$DIR/data.bin" --queries "$DIR/query.bin" \
    --engine "$ENGINE" --output "$DIR/$ENGINE.bin" --device "$DEVICE" "${EXTRA[@]}" \
    > "$DIR/logs/$ENGINE.txt" 2>&1 || { tail -5 "$DIR/logs/$ENGINE.txt"; exit 1; }
  tail -1 "$DIR/logs/$ENGINE.txt"
done

echo "== differential comparison (exact engines) =="
python -m hvq_tpu_torch.cli compare \
  "$DIR/oracle.bin" "$DIR/batched.bin" "$DIR/partitioned.bin" "$DIR/paged.bin" \
  "$DIR/sharded.bin" "$DIR/partitioned_sharded.bin"

echo "== ivf recall vs oracle =="
python - "$DIR" <<'EOF'
import sys

from hvq_tpu_torch.utils import formats
from hvq_tpu_torch.utils.compare import recall_at_k

d = sys.argv[1]
oracle = formats.read_knn(f"{d}/oracle.bin")
ivf = formats.read_knn(f"{d}/ivf.bin")
od = formats.read_dist(f"{d}/oracle.bin.dist")
ivd = formats.read_dist(f"{d}/ivf.bin.dist")
rec = recall_at_k(ivf, oracle, ivd, od)
print(f"ivf recall@100 vs oracle: {rec:.4f}")
sys.exit(0 if rec >= 0.99 else 2)
EOF
