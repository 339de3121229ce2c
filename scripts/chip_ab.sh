#!/bin/bash
# Compare this checkout's port with another checkout of the repo on one
# NVIDIA card, in turns: this, other, this, other.  Each turn runs that
# checkout's chip_smoke.py and this checkout's scripts/wrapper_cost.py on
# that checkout's kernels; then this checkout's CUDA tests run once.
#
#     bash scripts/chip_ab.sh OTHER_CHECKOUT [OUT_DIR]
#
# Logs land in OUT_DIR (default: build/ab under this checkout):
# smoke_<turn>.log, wrapper_<turn>.json and cuda_tests.log, where <turn> is
# this1, other1, this2, other2.  Each line of the summary printed at the
# end names the file it comes from.  Exits non-zero if any step failed.
set -u
HERE=$(cd "$(dirname "$0")/.." && pwd)
OTHER=$(cd "$1" && pwd)
OUT=$(mkdir -p "${2:-$HERE/build/ab}" && cd "${2:-$HERE/build/ab}" && pwd)
status=0
for turn in this1 other1 this2 other2; do
  case $turn in this*) root=$HERE ;; *) root=$OTHER ;; esac
  (cd "$root" && timeout 900 python3 chip_smoke.py) > "$OUT/smoke_$turn.log" 2>&1
  rc=$?; echo "smoke_$turn.log rc=$rc"; [ $rc = 0 ] || status=1
  timeout 300 python3 "$HERE/scripts/wrapper_cost.py" --root "$root" \
    > "$OUT/wrapper_$turn.json" 2> "$OUT/wrapper_$turn.err"
  rc=$?; echo "wrapper_$turn.json rc=$rc"; [ $rc = 0 ] || status=1
done
(cd "$HERE" && PYTHONPATH=src timeout 900 python3 -m pytest --noconftest \
  -p no:cacheprovider -q tests/test_torch_cuda.py) > "$OUT/cuda_tests.log" 2>&1
rc=$?; echo "cuda_tests.log rc=$rc: $(tail -n 1 "$OUT/cuda_tests.log")"
[ $rc = 0 ] || status=1
for turn in this1 other1 this2 other2; do
  echo "== smoke_$turn.log"
  grep -E "^\[build\]|_attention at|ssd_scan at|decode step|prefill of|busy share|^ +[0-9.]+ ms x|engine\[" \
    "$OUT/smoke_$turn.log" | cut -c1-400
  tail -n 3 "$OUT/smoke_$turn.log" | cut -c1-2500
  echo "== wrapper_$turn.json"; cat "$OUT/wrapper_$turn.json"
done
exit $status
