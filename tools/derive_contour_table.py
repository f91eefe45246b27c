"""Derive the local vertex-config table for cv2.contourArea parity.

Theory (see tpu_inspect/ops/contour.py): the Green's-theorem area of the
Suzuki-traced external contour of a blob decomposes into a sum over crack
vertices (2x2 pixel windows) of contributions that are linear in the vertex
coordinates, with coefficients depending only on the local 3-state config
(2 = pixel of the top-level blob, 1 = exterior background, 0 = anything
else: holes or nested blobs). This script derives the 81x3 coefficient
table empirically:

1. generate diverse random masks (blobs, noise, lines, checkers),
2. per top-level blob: target = cv2.contourArea of its RETR_EXTERNAL
   contour; features = per-config (count, sum of vertex x, sum of vertex y),
3. least-squares fit -> round to 1/8 -> exact-verify on held-out masks.

Writes the verified table to tpu_inspect/ops/_contour_table.py.
"""

from __future__ import annotations

import pathlib
import sys

import cv2
import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from tpu_inspect.synthetic import random_blob_mask  # noqa: E402


def analyze_mask(mask: np.ndarray):
    """Per-top-level-blob (target contourArea, features dict)."""
    h, w = mask.shape
    fg = (mask > 0).astype(np.uint8)

    # exterior: bg 4-connected to border (pad trick)
    inv = (1 - fg).astype(np.uint8)
    padded = np.pad(inv, 1, constant_values=1)
    n_ext, lab_ext = cv2.connectedComponents(padded, connectivity=4)
    ext = np.zeros((h + 2, w + 2), dtype=bool)
    ext_label = lab_ext[0, 0]
    ext[lab_ext == ext_label] = True
    ext = ext[1:-1, 1:-1]

    # fill regions: CC of ~ext (8-conn); root = raster-first pixel
    notext = (~ext).astype(np.uint8)
    n_fill, lab_fill = cv2.connectedComponents(notext, connectivity=8)

    # fg CCs (8-conn)
    n_fg, lab_fg = cv2.connectedComponents(fg, connectivity=8)

    # top-level fg component per fill region: the fg CC that contains the
    # fill region's raster-first pixel
    flat_fill = lab_fill.ravel()
    first_idx = {}
    for i, v in enumerate(flat_fill):
        if v != 0 and v not in first_idx:
            first_idx[v] = i
    top_fg_cc = {}  # fill label -> fg cc label
    for v, i in first_idx.items():
        y, x = divmod(i, w)
        assert fg[y, x], "fill-region raster-first pixel must be fg"
        top_fg_cc[v] = lab_fg[y, x]

    # state map: 2 = top-level fg, 1 = exterior, 0 = else
    state = np.zeros((h, w), dtype=np.int64)
    state[ext] = 1
    for v, fgcc in top_fg_cc.items():
        state[(lab_fill == v) & (lab_fg == fgcc)] = 2

    # per-vertex configs: vertices (h+1) x (w+1); out-of-image = exterior(1)
    sp = np.pad(state, 1, constant_values=1)
    s00 = sp[:-1, :-1]
    s01 = sp[:-1, 1:]
    s10 = sp[1:, :-1]
    s11 = sp[1:, 1:]
    cfg = s00 + 3 * s01 + 9 * s10 + 27 * s11  # [(h+1), (w+1)]

    # attribution: fill label of the top-fg pixel(s) in the window
    lf = np.where(state == 2, lab_fill, 0)
    lp = np.pad(lf, 1, constant_values=0)
    attr = np.maximum(
        np.maximum(lp[:-1, :-1], lp[:-1, 1:]), np.maximum(lp[1:, :-1], lp[1:, 1:])
    )

    # reference targets: RETR_EXTERNAL contours mapped to fill labels
    cnts, _ = cv2.findContours(fg.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    targets = {}
    for c in cnts:
        x0, y0 = c[0, 0, 0], c[0, 0, 1]
        v = lab_fill[y0, x0]
        assert v != 0
        assert v not in targets, "two external contours in one fill region?"
        targets[v] = cv2.contourArea(c)

    # features per blob
    vy, vx = np.mgrid[0 : h + 1, 0 : w + 1]
    out = []
    for v, target in targets.items():
        sel = attr == v
        cfgs = cfg[sel]
        xs = vx[sel]
        ys = vy[sel]
        feat = np.zeros((81, 3), dtype=np.float64)
        np.add.at(feat[:, 0], cfgs, 1.0)
        np.add.at(feat[:, 1], cfgs, xs.astype(np.float64))
        np.add.at(feat[:, 2], cfgs, ys.astype(np.float64))
        out.append((target, feat))
    return out


def gen_masks(seed, n=300):
    rng = np.random.RandomState(seed)
    masks = []
    for i in range(n):
        kind = i % 6
        h = rng.randint(8, 40)
        w = rng.randint(8, 40)
        if kind == 0:
            m = random_blob_mask(h, w, seed=seed * 1000 + i, n_blobs=rng.randint(1, 6))
        elif kind == 1:
            m = (rng.rand(h, w) < rng.uniform(0.2, 0.8)).astype(np.uint8) * 255
        elif kind == 2:  # sparse single pixels + short lines
            m = np.zeros((h, w), np.uint8)
            for _ in range(rng.randint(1, 10)):
                y, x = rng.randint(0, h), rng.randint(0, w)
                m[y, x] = 255
            for _ in range(rng.randint(0, 4)):
                y, x = rng.randint(0, h), rng.randint(0, w)
                L = rng.randint(2, 10)
                dy, dx = rng.choice([-1, 0, 1]), rng.choice([-1, 0, 1])
                for t in range(L):
                    yy, xx = y + t * dy, x + t * dx
                    if 0 <= yy < h and 0 <= xx < w:
                        m[yy, xx] = 255
        elif kind == 3:  # blobs with holes
            m = random_blob_mask(h, w, seed=seed * 999 + i, n_blobs=3)
            holes = random_blob_mask(h, w, seed=seed * 77 + i, n_blobs=5, scale=0.1)
            m[holes > 0] = 0
        elif kind == 4:  # nested: ring + inner dot
            m = np.zeros((h, w), np.uint8)
            cy, cx = h // 2, w // 2
            r = min(h, w) // 2 - 1
            yy, xx = np.mgrid[0:h, 0:w]
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            m[(d2 <= r * r) & (d2 >= (r - 2) ** 2)] = 255
            m[cy, cx] = 255
        else:  # checker-ish diagonal contacts
            m = ((rng.rand(h, w) < 0.5).astype(np.uint8)) * 255
            m[::2, ::2] = 255
        masks.append(m)
    return masks


def main():
    rows, ys = [], []
    for m in gen_masks(1, 400):
        for target, feat in analyze_mask(m):
            rows.append(feat.ravel())
            ys.append(target)
    A = np.array(rows)
    b = np.array(ys)
    print(f"fit system: {A.shape}, targets {len(b)}")
    # try signed fit both ways; contourArea is |signed|/... orientation unknown
    coef, res, rank, _ = np.linalg.lstsq(A, b, rcond=None)
    pred = A @ coef
    print("fit rank", rank, "max resid", np.abs(pred - b).max())
    # NOTE: the min-norm solution is rank-deficient (feature collinearities
    # forced by boundary geometry) so entries are not nice rationals, but its
    # predictions are exact for every reachable feature combination; final
    # areas are snapped to the nearest 0.5 (contourArea is a half-integer).
    cq = coef

    # held-out verification
    bad = 0
    total = 0
    for m in gen_masks(2, 400):
        for target, feat in analyze_mask(m):
            total += 1
            got = round(float(feat.ravel() @ cq) * 2) / 2
            if got != target:
                bad += 1
                if bad <= 5:
                    print("MISMATCH target", target, "got", got)
    print(f"held-out: {bad}/{total} mismatches")
    if bad == 0:
        table = cq.reshape(81, 3)
        with open(REPO / "tpu_inspect" / "ops" / "_contour_table.py", "w") as f:
            f.write(
                '"""Auto-derived by tools/derive_contour_table.py — do not edit.\n\n'
                "Per 3-state 2x2 vertex config (code = s00 + 3*s01 + 9*s10 + 27*s11,\n"
                "states: 0=hole/nested, 1=exterior, 2=top-level blob; window rows are\n"
                "(y-1, y), cols (x-1, x)): contourArea contribution\n"
                "alpha + beta*vx + gamma*vy. Exact-verified vs cv2.contourArea on\n"
                'held-out random masks."""\n\nimport numpy as np\n\n'
            )
            f.write("CONTOUR_TABLE = np.array([\n")
            for i in range(81):
                f.write(
                    f"    [{table[i,0]!r}, {table[i,1]!r}, {table[i,2]!r}],\n"
                )
            f.write("], dtype=np.float64)\n")
        print("table written")
    return bad


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
