#!/usr/bin/env bash
# Data-parallel training on the GPUs of one host: torchrun starts one
# process per GPU, each running pdanet_tpu_torch.tools.train with
# --launcher pytorch (rank, world and rendezvous from torchrun's
# environment, NCCL between the GPUs; with --device cpu, Gloo between CPU
# processes).  --batch_size is per GPU: the global batch is
# NGPUS x batch_size.
#
# Runs from the caller's working directory (output/ lands there, and
# --cfg_file is relative to it, as the reference's dist_train.sh run from
# tools/).
#
# Usage: dist_train.sh <NGPUS> <train args...>
set -euo pipefail
NGPUS=$1
shift
ROOT="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m torch.distributed.run --standalone --nproc_per_node="$NGPUS" \
    -m pdanet_tpu_torch.tools.train --launcher pytorch "$@"
