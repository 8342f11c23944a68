#!/usr/bin/env bash
# Multi-process evaluation under SLURM, one task per GPU, over as many
# nodes as GPUS and GPUS_PER_NODE (8) take: each task runs
# pdanet_tpu_torch.tools.test with --launcher slurm on its shard of the
# frames, the predictions are merged into dataset order and rank 0
# evaluates them.  The rendezvous as slurm_train.sh's; CPUS_PER_TASK (5)
# and SRUN_ARGS pass on to srun.
#
# Runs from the caller's working directory (output/ lands there).
#
# Usage: slurm_test.sh <PARTITION> <JOB_NAME> <GPUS> <test args...>
set -euo pipefail
PARTITION=$1
JOB_NAME=$2
GPUS=$3
shift 3
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
CPUS_PER_TASK=${CPUS_PER_TASK:-5}
SRUN_ARGS=${SRUN_ARGS:-""}
ROOT="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
PORT=${PORT:-$(python3 -c 'import socket; s = socket.socket(); s.bind(("", 0))
print(s.getsockname()[1])')}
# shellcheck disable=SC2086
exec srun -p "$PARTITION" --job-name="$JOB_NAME" --gres=gpu:"$GPUS_PER_NODE" \
    --ntasks="$GPUS" --ntasks-per-node="$GPUS_PER_NODE" --cpus-per-task="$CPUS_PER_TASK" \
    --kill-on-bad-exit=1 $SRUN_ARGS \
    python3 -u -m pdanet_tpu_torch.tools.test --launcher slurm --tcp_port "$PORT" "$@"
