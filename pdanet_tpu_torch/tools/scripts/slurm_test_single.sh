#!/usr/bin/env bash
# Evaluation under SLURM as one task on one GPU
# (pdanet_tpu_torch.tools.test without a launcher).  SRUN_ARGS passes on
# to srun.
#
# Runs from the caller's working directory (output/ lands there).
#
# Usage: slurm_test_single.sh <PARTITION> <test args...>
set -euo pipefail
PARTITION=$1
shift
SRUN_ARGS=${SRUN_ARGS:-""}
ROOT="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
# shellcheck disable=SC2086
exec srun -p "$PARTITION" --job-name=eval --gres=gpu:1 --ntasks=1 --ntasks-per-node=1 \
    --kill-on-bad-exit=1 $SRUN_ARGS \
    python3 -u -m pdanet_tpu_torch.tools.test "$@"
