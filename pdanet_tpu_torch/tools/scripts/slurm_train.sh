#!/usr/bin/env bash
# Data-parallel training under SLURM, one task per GPU (the reference's
# process model): srun starts GPUS tasks, GPUS_PER_NODE a node, each
# running pdanet_tpu_torch.tools.train with --launcher slurm, which reads
# its rank, world and local GPU from SLURM_PROCID, SLURM_NTASKS and
# SLURM_LOCALID and the rendezvous host from the first of SLURM_NODELIST,
# on --tcp_port (PORT, else a port free on this host).  GPUS_PER_NODE
# (8), CPUS_PER_TASK (5) and SRUN_ARGS pass on to srun.
#
# Runs from the caller's working directory (output/ lands there).
#
# Usage: slurm_train.sh <PARTITION> <JOB_NAME> <GPUS> <train args...>
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
# shellcheck disable=SC2086  # SRUN_ARGS is a list of srun options
exec srun -p "$PARTITION" --job-name="$JOB_NAME" --gres=gpu:"$GPUS_PER_NODE" \
    --ntasks="$GPUS" --ntasks-per-node="$GPUS_PER_NODE" --cpus-per-task="$CPUS_PER_TASK" \
    --kill-on-bad-exit=1 $SRUN_ARGS \
    python3 -u -m pdanet_tpu_torch.tools.train --launcher slurm --tcp_port "$PORT" "$@"
