"""VP9 backward probability adaptation (VP9 spec §9.2; reference:
libavcodec/vp9prob.c ff_vp9_adapt_probs). Mutates the saved frame
context in place from the frame's symbol counts.

The port's copy of ffmpeg_tpu/codecs/vp9/prob.py, held equal to it by
tests/test_torch_host_copies.py."""

from __future__ import annotations


def _adapt(arr, idx, ct0, ct1, max_count, uf):
    ct = ct0 + ct1
    if not ct:
        return
    uf = (uf * min(ct, max_count)) // max_count
    p1 = int(arr[idx])
    p2 = ((ct0 << 8) + (ct >> 1)) // ct
    p2 = max(1, min(255, p2))
    arr[idx] = p1 + (((p2 - p1) * uf + 128) >> 8)


def adapt_probs(ctx, h, counts, working, last_keyframe):
    """ctx: the saved ProbContext being refreshed; h: VP9Header;
    counts: FrameState.counts; working: this frame's FrameProbs (its
    forward-updated tx/skip are copied back on key/intra frames)."""
    uf = 112 if (h.keyframe or h.intraonly or not last_keyframe) \
        else 128

    # coefficients
    for i in range(4):
        for j in range(2):
            for k in range(2):
                for l in range(6):
                    for m in range(6):
                        if l == 0 and m >= 3:
                            break
                        pp = ctx.coef3[i, j, k, l, m]
                        e = counts["eob"][i][j][k][l][m]
                        c = counts["coef"][i][j][k][l][m]
                        _adapt(pp, 0, int(e[0]), int(e[1]), 24, uf)
                        _adapt(pp, 1, int(c[0]),
                               int(c[1]) + int(c[2]), 24, uf)
                        _adapt(pp, 2, int(c[1]), int(c[2]), 24, uf)

    if h.keyframe or h.intraonly:
        ctx.skip[:] = working.skip
        ctx.tx32p[:] = working.tx32p
        ctx.tx16p[:] = working.tx16p
        ctx.tx8p[:] = working.tx8p
        return

    for i in range(3):
        _adapt(ctx.skip, i, int(counts["skip"][i][0]),
               int(counts["skip"][i][1]), 20, 128)
    for i in range(4):
        _adapt(ctx.intra, i, int(counts["intra"][i][0]),
               int(counts["intra"][i][1]), 20, 128)
    if h.comppredmode == 2:               # PRED_SWITCHABLE
        for i in range(5):
            _adapt(ctx.comp, i, int(counts["comp"][i][0]),
                   int(counts["comp"][i][1]), 20, 128)
    if h.comppredmode != 0:               # != PRED_SINGLEREF
        for i in range(5):
            _adapt(ctx.comp_ref, i, int(counts["comp_ref"][i][0]),
                   int(counts["comp_ref"][i][1]), 20, 128)
    if h.comppredmode != 1:               # != PRED_COMPREF
        for i in range(5):
            c = counts["single_ref"][i]
            _adapt(ctx.single_ref[i], 0, int(c[0][0]), int(c[0][1]),
                   20, 128)
            _adapt(ctx.single_ref[i], 1, int(c[1][0]), int(c[1][1]),
                   20, 128)
    for i in range(4):
        for j in range(4):
            pp = ctx.partition[i][j]
            c = [int(v) for v in counts["partition"][i][j]]
            _adapt(pp, 0, c[0], c[1] + c[2] + c[3], 20, 128)
            _adapt(pp, 1, c[1], c[2] + c[3], 20, 128)
            _adapt(pp, 2, c[2], c[3], 20, 128)
    if h.txfmmode == 4:                   # TX_SWITCHABLE
        for i in range(2):
            c16 = [int(v) for v in counts["tx16p"][i]]
            c32 = [int(v) for v in counts["tx32p"][i]]
            _adapt(ctx.tx8p, i, int(counts["tx8p"][i][0]),
                   int(counts["tx8p"][i][1]), 20, 128)
            _adapt(ctx.tx16p[i], 0, c16[0], c16[1] + c16[2], 20, 128)
            _adapt(ctx.tx16p[i], 1, c16[1], c16[2], 20, 128)
            _adapt(ctx.tx32p[i], 0, c32[0],
                   c32[1] + c32[2] + c32[3], 20, 128)
            _adapt(ctx.tx32p[i], 1, c32[1], c32[2] + c32[3], 20, 128)
            _adapt(ctx.tx32p[i], 2, c32[2], c32[3], 20, 128)
    if h.filtermode == 4:                 # FILTER_SWITCHABLE
        for i in range(4):
            c = [int(v) for v in counts["filter"][i]]
            _adapt(ctx.filter[i], 0, c[0], c[1] + c[2], 20, 128)
            _adapt(ctx.filter[i], 1, c[1], c[2], 20, 128)
    for i in range(7):
        c = [int(v) for v in counts["mv_mode"][i]]
        # counts indexed mode-10: [NEARESTMV, NEARMV, ZEROMV, NEWMV]
        _adapt(ctx.mv_mode[i], 0, c[2], c[1] + c[0] + c[3], 20, 128)
        _adapt(ctx.mv_mode[i], 1, c[0], c[1] + c[3], 20, 128)
        _adapt(ctx.mv_mode[i], 2, c[1], c[3], 20, 128)
    c = [int(v) for v in counts["mv_joint"]]
    _adapt(ctx.mv_joint, 0, c[0], c[1] + c[2] + c[3], 20, 128)
    _adapt(ctx.mv_joint, 1, c[1], c[2] + c[3], 20, 128)
    _adapt(ctx.mv_joint, 2, c[2], c[3], 20, 128)
    mvc = counts["mv_comp"]
    for i in range(2):
        mc = ctx.mv_comp[i]
        _adapt(mc, 0, int(mvc["sign"][i][0]), int(mvc["sign"][i][1]),
               20, 128)
        c = [int(v) for v in mvc["classes"][i]]
        s = sum(c[1:])
        _adapt(mc, 1, c[0], s, 20, 128)
        s -= c[1]
        _adapt(mc, 2, c[1], s, 20, 128)
        s -= c[2] + c[3]
        _adapt(mc, 3, c[2] + c[3], s, 20, 128)
        _adapt(mc, 4, c[2], c[3], 20, 128)
        s -= c[4] + c[5]
        _adapt(mc, 5, c[4] + c[5], s, 20, 128)
        _adapt(mc, 6, c[4], c[5], 20, 128)
        s -= c[6]
        _adapt(mc, 7, c[6], s, 20, 128)
        _adapt(mc, 8, c[7] + c[8], c[9] + c[10], 20, 128)
        _adapt(mc, 9, c[7], c[8], 20, 128)
        _adapt(mc, 10, c[9], c[10], 20, 128)
        _adapt(mc, 11, int(mvc["class0"][i][0]),
               int(mvc["class0"][i][1]), 20, 128)
        for j in range(10):
            _adapt(mc, 12 + j, int(mvc["bits"][i][j][0]),
                   int(mvc["bits"][i][j][1]), 20, 128)
        for j in range(2):
            c = [int(v) for v in mvc["class0_fp"][i][j]]
            base = 22 + 3 * j
            _adapt(mc, base + 0, c[0], c[1] + c[2] + c[3], 20, 128)
            _adapt(mc, base + 1, c[1], c[2] + c[3], 20, 128)
            _adapt(mc, base + 2, c[2], c[3], 20, 128)
        c = [int(v) for v in mvc["fp"][i]]
        _adapt(mc, 28, c[0], c[1] + c[2] + c[3], 20, 128)
        _adapt(mc, 29, c[1], c[2] + c[3], 20, 128)
        _adapt(mc, 30, c[2], c[3], 20, 128)
        if h.highprecisionmvs:
            _adapt(mc, 31, int(mvc["class0_hp"][i][0]),
                   int(mvc["class0_hp"][i][1]), 20, 128)
            _adapt(mc, 32, int(mvc["hp"][i][0]),
                   int(mvc["hp"][i][1]), 20, 128)

    # y/uv intra modes: tree-ordered adaptation (vp9prob.c:233)
    def modes_tree(pp, c):
        s = c[0] + c[1] + c[3] + c[4] + c[5] + c[6] + c[7] + c[8] + \
            c[9]
        _adapt(pp, 0, c[2], s, 20, 128)       # DC
        s -= c[9]
        _adapt(pp, 1, c[9], s, 20, 128)       # TM
        s -= c[0]
        _adapt(pp, 2, c[0], s, 20, 128)       # VERT
        s2 = c[1] + c[4] + c[5]
        s -= s2
        _adapt(pp, 3, s2, s, 20, 128)
        s2 -= c[1]
        _adapt(pp, 4, c[1], s2, 20, 128)      # HOR
        _adapt(pp, 5, c[4], c[5], 20, 128)    # DDR vs VR
        s -= c[3]
        _adapt(pp, 6, c[3], s, 20, 128)       # DDL
        s -= c[7]
        _adapt(pp, 7, c[7], s, 20, 128)       # VL
        _adapt(pp, 8, c[6], c[8], 20, 128)    # HD vs HU

    for i in range(4):
        modes_tree(ctx.y_mode[i],
                   [int(v) for v in counts["y_mode"][i]])
    for i in range(10):
        modes_tree(ctx.uv_mode[i],
                   [int(v) for v in counts["uv_mode"][i]])
