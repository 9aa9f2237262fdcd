#!/bin/bash
# The port's four heavy full-refinement oracles on the CUDA card (free-flying
# robot, shuttle reentry, space station, tumour anti-angiogenesis): the
# ``heavy`` and ``cuda`` cases of tests/test_torch_oracles.py, which hold
# each ``problem.solve(device="cuda")`` to the reference's GPOPS-II gate with
# the mesh tolerance met.  Writes HEAVY_torch_<tag>.json: the keys of
# scripts/run_heavy_oracles.sh (rc, ok, wall_s, summary), per oracle the
# final objective, the mesh iterations, whether the mesh tolerance was met
# and the wall seconds (from each test's ``ORACLE`` line), and the card's
# name and power limit.  The pytest log goes to _scratch/.
#
# Usage, from the root of a checkout on a machine with a CUDA card:
#   scripts/run_heavy_oracles_torch.sh [tag]
set -u
TAG="${1:-manual}"
OUT="HEAVY_torch_${TAG}.json"
mkdir -p _scratch
LOG="_scratch/heavy_torch_${TAG}.log"
START=$(date +%s)
python -m pytest tests/test_torch_oracles.py -m "heavy and cuda" \
    --noconftest -q -rA -p no:cacheprovider > "$LOG" 2>&1
RC=$?
END=$(date +%s)
SUMMARY=$(tail -1 "$LOG" | tr -d '"')
CARD=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    2>/dev/null | head -1)
python - "$OUT" "$RC" "$((END-START))" "$SUMMARY" "$CARD" "$LOG" <<'PY'
import json, sys
out, rc, secs, summary, card, log = sys.argv[1:7]
oracles = {}
for line in open(log):
    if line.startswith("ORACLE "):
        rec = json.loads(line[len("ORACLE "):])
        oracles[rec.pop("oracle")] = rec
json.dump({"rc": int(rc), "ok": int(rc) == 0, "wall_s": int(secs),
           "summary": summary, "card": card, "oracles": oracles},
          open(out, "w"), indent=1)
print(open(out).read())
PY
exit $RC
