#!/usr/bin/env bash
# Multi-process evaluation under SLURM on the GPUS GPUs of one node, one
# task per GPU (pdanet_tpu_torch.tools.test --launcher slurm; the
# rendezvous as slurm_train.sh's).  SRUN_ARGS passes on to srun.
#
# Runs from the caller's working directory (output/ lands there).
#
# Usage: slurm_test_mgpu.sh <PARTITION> <GPUS> <test args...>
set -euo pipefail
PARTITION=$1
GPUS=$2
shift 2
SRUN_ARGS=${SRUN_ARGS:-""}
ROOT="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
PORT=${PORT:-$(python3 -c 'import socket; s = socket.socket(); s.bind(("", 0))
print(s.getsockname()[1])')}
# shellcheck disable=SC2086
exec srun -p "$PARTITION" --job-name=eval --gres=gpu:"$GPUS" --ntasks="$GPUS" \
    --ntasks-per-node="$GPUS" --kill-on-bad-exit=1 $SRUN_ARGS \
    python3 -u -m pdanet_tpu_torch.tools.test --launcher slurm --tcp_port "$PORT" "$@"
