#!/usr/bin/env bash
# Run the CI pipeline end-to-end locally: every CI command must be executable
# from a clean checkout. Mirrors .github/workflows/ci.yml job-for-job; steps whose
# tooling is absent locally (ruff, build) are skipped with a notice rather
# than silently passed.
set -euo pipefail
cd "$(dirname "$0")/.."

fail=0

echo "== lint (ruff) =="
if command -v ruff >/dev/null 2>&1; then
    ruff check gr4_packet_modem_tpu apps benchmarks tests examples scripts bench.py || fail=1
else
    echo "SKIP: ruff not installed"
fi

echo "== native (gcc) =="
make -C native CXX=g++ || fail=1

echo "== native (clang) =="
if command -v clang++ >/dev/null 2>&1; then
    make -C native CXX=clang++ || fail=1
else
    echo "SKIP: clang++ not installed"
fi

echo "== tests =="
python -m pytest tests/ -q || fail=1

echo "== wheel build + smoke import =="
if python -c "import build" >/dev/null 2>&1; then
    rm -rf dist/
    # --no-isolation: the isolated build env needs network to fetch
    # setuptools; the host env already has it (offline-friendly, same
    # wheel content as the CI job's isolated build)
    python -m build --wheel --no-isolation || fail=1
    # same smoke command as the wheel job (run against the source tree when
    # installing the wheel isn't possible without network access)
    python -c "import gr4_packet_modem_tpu; from gr4_packet_modem_tpu.registry import BLOCK_REGISTRY; print(len(BLOCK_REGISTRY), 'blocks')" || fail=1
else
    echo "SKIP: python-build not installed; running smoke import from source tree"
    python -c "import gr4_packet_modem_tpu; from gr4_packet_modem_tpu.registry import BLOCK_REGISTRY; print(len(BLOCK_REGISTRY), 'blocks')" || fail=1
fi

if [ "$fail" -ne 0 ]; then
    echo "CI LOCAL: FAILED"
    exit 1
fi
echo "CI LOCAL: OK"
