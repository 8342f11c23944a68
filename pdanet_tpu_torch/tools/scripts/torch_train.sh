#!/usr/bin/env bash
# Data-parallel training on the GPUs of one host through torchrun, one
# process per GPU, each running pdanet_tpu_torch.tools.train with
# --launcher pytorch (torchrun exports RANK, WORLD_SIZE, LOCAL_RANK,
# MASTER_ADDR and MASTER_PORT), its rendezvous on a free local port
# (PORT to choose one).  The reference's torch_train.sh; dist_train.sh is
# the same launch with torchrun's --standalone rendezvous.
#
# Runs from the caller's working directory (output/ lands there).
#
# Usage: torch_train.sh <NGPUS> <train args...>
set -euo pipefail
NGPUS=$1
shift
ROOT="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
PORT=${PORT:-$(python3 -c 'import socket; s = socket.socket(); s.bind(("", 0))
print(s.getsockname()[1])')}
exec torchrun --nproc_per_node="$NGPUS" --rdzv_endpoint="localhost:$PORT" \
    -m pdanet_tpu_torch.tools.train --launcher pytorch "$@"
