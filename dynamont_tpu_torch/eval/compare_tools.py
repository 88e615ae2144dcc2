"""Segmentation benchmark harness: border-distance metrics vs ground-truth
changepoints, random/uniform controls, segment-length distributions
(ref: src/python/misc/compareTools.py).
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser

import numpy as np


def evaluate(gt: np.ndarray, pred: np.ndarray, max_distance: int) -> np.ndarray:
    """Count, per distance offset in [-max_distance, max_distance], how many
    ground-truth changepoints have their closest prediction within that
    distance. Faithful port of the reference matching logic incl. the
    neighbor-stealing resolution (ref: compareTools.py:319-394).

    Returns an int array of length 2*max_distance+1; index d corresponds to
    signed distance (max_distance - d).
    """
    gt = np.sort(np.asarray(gt))
    pred = np.sort(np.asarray(pred))
    found = np.array([{} for _ in range(len(gt))])

    pred_start = 0
    for gi in range(len(gt)):
        gv = int(gt[gi])
        for pi in range(pred_start, len(pred)):
            pv = int(pred[pi])
            if gv - pv > max_distance:
                continue
            elif gv - pv < -max_distance:
                break
            found[gi][pi] = gv - pv
        pred_start = min(found[gi].keys()) if found[gi] else 0

    result = np.zeros(2 * max_distance + 1, dtype=int)
    for gi in range(len(gt)):
        if not found[gi]:
            continue
        cur = found[gi]
        pi = min(cur, key=lambda k: abs(cur[k]))
        # Deviation from the reference: compareTools.py:357-376 re-selects
        # with `key=lambda k: abs(cur[pi])` after deleting pi from cur — a
        # KeyError at call time whenever stealing leaves other candidates.
        # We re-select by the candidate under consideration (abs(cur[k])),
        # which is the evident intent.
        prev = found[gi - 1] if gi > 0 else {}
        if prev and cur and pi in prev and abs(prev[pi]) <= abs(cur[pi]):
            del cur[pi]
            if cur:
                pi = min(cur, key=lambda k: abs(cur[k]))
        nxt = found[gi + 1] if gi < len(gt) - 1 else {}
        if nxt and cur and pi in nxt and abs(nxt[pi]) < abs(cur[pi]):
            del cur[pi]
            if cur:
                pi = min(cur, key=lambda k: abs(cur[k]))
        if not cur:
            continue
        d = int(cur[pi])
        if d >= 0:
            result[: max_distance - d + 1] += 1
        if d <= 0:
            result[max_distance - d:] += 1
        if d == 0:
            result[max_distance] -= 1
    return result


def cumulative_ratio(result: np.ndarray, n_gt: int, max_distance: int):
    """Found-changepoint ratio per absolute distance threshold
    (ref: compareTools.py plot preparation)."""
    out = []
    for d in range(max_distance + 1):
        lo, hi = max_distance - d, max_distance + d
        # result[i] counts gts whose best match is within the signed offset;
        # symmetric window = value at both edges (they're cumulative in the
        # reference encoding: result[:m-d+1] and result[m-d:] increments)
        found = result[lo] + result[hi] - result[max_distance] if d > 0 else result[max_distance]
        out.append((d, found / max(1, n_gt)))
    return out


def generate_control(regions: dict, seed: int | None = None):
    """Random + equidistant border controls (ref: compareTools.py:464-505).

    regions: {readid: [(n_bases, sig_start, sig_end), ...]}.
    """
    rng = np.random.default_rng(seed)
    random_borders = {}
    uniform_borders = {}
    for readid, regs in regions.items():
        nts_total = sum(r[0] for r in regs)
        all_positions = np.concatenate([np.arange(r[1], r[2]) for r in regs])
        random_borders[readid] = rng.choice(
            all_positions, size=min(nts_total, len(all_positions)), replace=False
        )
        uniform_borders[readid] = np.concatenate(
            [np.linspace(r[1], r[2] - 1, r[0], dtype=int) for r in regs]
        )
    return random_borders, uniform_borders


def segment_lengths(segments_by_read: dict) -> np.ndarray:
    """Pooled segment lengths across reads for distribution plots."""
    out = []
    for segs in segments_by_read.values():
        for s in segs:
            out.append(int(s[1]) - int(s[0]))
    return np.asarray(out)


def borders_from_segments(segments) -> np.ndarray:
    """Changepoints = segment starts."""
    return np.asarray(sorted({int(s[0]) for s in segments}))


def _mad(x):
    med = np.median(x)
    return np.median(np.abs(x - med))


def score_segments(signal: np.ndarray, seg_pos: np.ndarray, window: int = 20) -> np.ndarray:
    """Per-border signal-quality scores (ref: compareTools.py:755-797):
    for each interior border, the median shift and MAD shift between the
    windows on either side, plus the trimmed-MAD homogeneity of the segment
    the border opens. Returns (n, 3) float32 [medShift, madShift, homogeneity].
    """
    seg_pos = np.asarray(seg_pos)
    sig_len = len(signal)
    scores = []
    for i in range(1, len(seg_pos) - 1):
        curr = int(seg_pos[i])
        nxt = int(seg_pos[i + 1])
        start = max(0, curr - window)
        end = min(curr + window, sig_len)
        w1 = signal[start:curr]
        w2 = signal[curr:end]
        med_shift = float(np.abs(np.median(w2) - np.median(w1)))
        mad_shift = float(np.abs(_mad(w2) - _mad(w1)))
        segment = signal[curr:nxt]
        if len(segment) >= 10:
            trim = max(int(0.1 * len(segment)), 1)
            homogeneity = float(_mad(segment[trim:-trim]))
        else:
            homogeneity = np.nan
        scores.append((med_shift, mad_shift, homogeneity))
    return np.asarray(scores, dtype=np.float32).reshape(-1, 3)


def score_tools(signals: dict, tool_borders: dict, window: int = 20):
    """CSV rows Tool,Score,Segment Quality for every tool/read
    (ref: compareTools.py:799-832 scoreTools). signals: {readid: signal};
    tool_borders: {tool: {readid: sorted border array}}."""
    rows = ["Tool,Score,Segment Quality"]
    common = set(signals)
    for borders in tool_borders.values():
        common &= set(borders)
    for readid in sorted(common):
        for tool, borders in tool_borders.items():
            sc = score_segments(signals[readid], borders[readid], window)
            for med_shift, mad_shift, homog in sc:
                rows.append(f"{tool},{med_shift},Median Delta")
                rows.append(f"{tool},{mad_shift},Mad Delta")
                rows.append(f"{tool},{homog},Homogeneity")
    return rows


def main(argv=None) -> None:
    """Compare one or more tool segmentations against ground-truth
    changepoints stored in an HDF5 (group per readid, dataset of positions).
    """
    p = ArgumentParser(prog="dynamont-compare-tools")
    p.add_argument("--gt", required=True, help="HDF5 with per-read changepoints")
    p.add_argument("--dynamont", default=None, help="dynamont CSV(.zst)")
    p.add_argument("--uncalled4", default=None)
    p.add_argument("--f5c-resquiggle", dest="f5c_resquiggle", default=None)
    p.add_argument("--tombo", default=None,
                   help="tombo single-fast5 directory (ref: compareTools.py:44)")
    p.add_argument("--dorado", default=None,
                   help="dorado move TSV from dynamont-convert dorado-moves")
    p.add_argument("--max-distance", type=int, default=50)
    p.add_argument("--controls", action="store_true",
                   help="also score random/uniform border controls "
                        "(ref: compareTools.py:464-505)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--plot", default=None, metavar="PREFIX",
                   help="write found-ratio / segment-length figures with "
                        "this path prefix (ref: compareTools.py:799-1203)")
    p.add_argument("-o", "--out", required=True, help="output CSV of ratios")
    args = p.parse_args(argv)

    import h5py

    from dynamont_tpu_torch.plot import readers as tool_readers

    with h5py.File(args.gt) as h5:
        gts = {rid: np.asarray(h5[rid]) for rid in h5}

    # each tool maps readid -> sorted border array (tombo natively emits
    # borders; segment-file tools go through borders_from_segments)
    tools = {}
    seg_tools = {}
    if args.dynamont:
        seg_tools["dynamont"] = lambda rid: tool_readers.read_dynamont(
            args.dynamont, rid)
    if args.uncalled4:
        seg_tools["uncalled4"] = lambda rid: tool_readers.read_uncalled4(
            args.uncalled4, rid)
    if args.f5c_resquiggle:
        seg_tools["f5c_resquiggle"] = lambda rid: tool_readers.read_f5c_resquiggle(
            args.f5c_resquiggle, rid, "", 5
        )
    if args.dorado:
        seg_tools["dorado"] = lambda rid: tool_readers.read_dorado(
            args.dorado, rid)
    for name, get in seg_tools.items():
        tools[name] = {}
        for rid in gts:
            segs = get(rid)
            if segs:
                tools[name][rid] = borders_from_segments(segs)
    if args.tombo:
        tombo = tool_readers.read_tombo_borders(args.tombo)
        tools["tombo"] = {rid: b for rid, b in tombo.items() if rid in gts}
    if args.controls:
        # control borders need per-read signal regions; approximate them
        # from the ground truth span with one border per gt changepoint
        regions = {
            rid: [(len(gt), int(np.min(gt)), int(np.max(gt)) + 1)]
            for rid, gt in gts.items() if len(gt)
        }
        rnd, uni = generate_control(regions, seed=args.seed)
        tools["control_random"] = {r: np.sort(v) for r, v in rnd.items()}
        tools["control_uniform"] = {r: np.sort(v) for r, v in uni.items()}

    rows = ["Tool,AbsoluteDistance,FoundRatio"]
    ratio_by_tool = {}
    for tool, borders in tools.items():
        total = np.zeros(2 * args.max_distance + 1, dtype=int)
        n_gt = 0
        for rid, gt in gts.items():
            pred = borders.get(rid)
            if pred is None or len(pred) == 0:
                continue
            total += evaluate(gt, pred, args.max_distance)
            n_gt += len(gt)
        ratios = cumulative_ratio(total, n_gt, args.max_distance)
        ratio_by_tool[tool] = ratios
        for d, ratio in ratios:
            rows.append(f"{tool},{d},{ratio}")
    with open(args.out, "w") as f:
        f.write("\n".join(rows) + "\n")
    print(f"wrote {args.out}", file=sys.stderr)

    if args.plot:
        from dynamont_tpu_torch.eval import figures

        figures.plot_found_ratios(ratio_by_tool, args.plot + "_found_ratio.png")
        figures.plot_border_upset(
            tools, gts, args.max_distance, args.plot + "_upset.png"
        )
        seg_lengths = {
            tool: np.concatenate(
                [np.diff(np.sort(b)) for b in borders.values() if len(b) > 1]
            ) if borders else np.array([])
            for tool, borders in tools.items()
        }
        figures.plot_segment_length_distributions(
            seg_lengths, args.plot + "_seglen.png"
        )


if __name__ == "__main__":
    main()
