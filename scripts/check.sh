#!/usr/bin/env bash
# One-command gate: every step must pass.
#
#   bash scripts/check.sh          # full gate (CPU suite + GPU steps)
#   bash scripts/check.sh --fast   # CPU suite only
#
# Steps:
#   1. fast pytest subset  (interface + bijectors + objectives; ~1 min)
#   2. full CPU suite      (default marks, then slow marks)
#   3. chip_smoke.py       (the trainer and the RQS kernel on one GPU)
#   4. bench.py            (scoreboard JSON; exits non-zero on any failure)
#   5. __graft_entry__     (entry point + 8-virtual-device mesh dry run)
#
# The compile cache is JAX_COMPILATION_CACHE_DIR when set, else
# <repo>/.jax_cache (normalizingflows.jl_tpu.device.init_compile_cache).
set -euo pipefail
cd "$(dirname "$0")/.."

step() { echo; echo "=== check: $1 ==="; }

step "fast pytest subset"
JAX_PLATFORMS=cpu python -m pytest tests/test_interface.py \
    tests/test_bijectors.py tests/test_objectives.py -q -x

step "full CPU suite (default marks)"
JAX_PLATFORMS=cpu python -m pytest tests/ -q

step "slow marks"
JAX_PLATFORMS=cpu python -m pytest tests/ -q -m slow

if [[ "${1:-}" == "--fast" ]]; then
    echo; echo "check: FAST MODE — GPU steps skipped"; exit 0
fi

step "on-card smoke run (chip_smoke.py)"
python chip_smoke.py

step "bench.py scoreboard"
python bench.py

step "entry point + 8-virtual-device sharded train step"
JAX_PLATFORMS=cpu python __graft_entry__.py
JAX_PLATFORMS=cpu python -c "import __graft_entry__ as g; \
  g.dryrun_multichip(8)"

echo; echo "=== check: ALL GREEN ==="
