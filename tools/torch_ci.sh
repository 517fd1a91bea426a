#!/bin/sh
# Recurring check of the PyTorch/CUDA port (snappier_tpu_torch), the twin
# of tools/ci.sh. The CPU legs run anywhere; where nvidia-smi lists a card,
# the card legs follow. Every leg stops the script on failure.
#
#   sh tools/torch_ci.sh
#
# Not here: benchmarks/run_all_torch.py --quick (the twin of ci.sh's
# run_all leg) comes with the port's benchmark.
set -e
cd "$(dirname "$0")/.."

# The port's tests, the slow ones included (the fuzz volumes, the rehearsal
# at 256 MiB), against the JAX package on the CPU.
JAX_PLATFORMS=cpu python -m pytest tests/ -q -k torch

# The multichip dry run on 8 CPU shards, both engines.
python -m snappier_tpu_torch.graft_entry 8 cpu

# The fuzz campaigns at their reduced volumes on the plain versions.
python3 tools/torch_fuzz.py --device cpu --quick

# The same tests with the C++ host runtime disabled: the native-only tests
# skip and the oracle and device engines carry the rest.
SNAPPIER_NO_NATIVE=1 JAX_PLATFORMS=cpu python -m pytest tests/ -q -k torch

# The multi-process rehearsal at a reduced size, and the ratio table.
python3 tools/torch_rehearsal_multihost.py 256 4 2 --device cpu
python3 tools/torch_ratio_table.py --device cpu

if command -v nvidia-smi >/dev/null 2>&1 && nvidia-smi -L 2>/dev/null | grep -q "^GPU"; then
    # The card: every kernel against its plain version and every path,
    # the CUDA tests without JAX, then the rehearsal (256 MiB, 4 processes
    # on the card) and the ratio table at their defaults.
    python3 chip_smoke.py
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
    python3 tools/torch_rehearsal_multihost.py
    python3 tools/torch_ratio_table.py
fi
