"""The reference's colour-space unpaired mapping, with gmapper-cs's
default options: filter 1 on the colour projection, the colour vector SW
(filter 2), pass 1, the four-layer DP and traceback of every pass-1 hit
(filter 3), the post-SW letter calls and posterior (common/sw-post.c),
pass 2, MAPQ and the SAM records."""
from __future__ import annotations

import math
from typing import List

import numpy as np

from mapbench.reference import common as K
from mapbench.reference import cs_sw, ls, sw


def cstols(first: int, colour: int) -> int:
    """util.h:157-180."""
    if first == K.BASE_N or not 0 <= colour <= 3:
        return K.BASE_N
    if first % 2 == 0:
        return (4 + first + colour) % 4
    return (4 + first - colour) % 4


def revcomp_cs(colours: np.ndarray, initbp: int) -> np.ndarray:
    """reverse_complement_read_cs (util.c:580-616)."""
    out = np.empty_like(colours)
    cur = initbp
    for c in colours:
        cur = cstols(cur, int(c))
    out[1:] = colours[:0:-1]
    out[0] = (K.COLOUR_MAT[cur, K.COMPLEMENT[initbp]] if cur <= 3
              else K.BASE_N)
    return out


def prepare(name: str, seq: str) -> K.Read:
    init = int(K.CHAR_TO_INT[ord(seq[0])])
    cols = K.CHAR_TO_INT[np.frombuffer(seq[1:].encode(), np.uint8)].astype(
        np.uint8)
    L = len(cols)
    return K.Read(name, seq, L, (cols, revcomp_cs(cols, init)),
                  int(K.abs_or_pct(K.WINDOW_LEN, L)), min_kmer_pos=1,
                  initbp=init)


def cs_strings(steps, gwin, qr, read_start: int, genome_start: int):
    """Alignment strings from the packed traceback steps (pretty_print,
    sw-full-cs.c:945-1060)."""
    d_chars, q_chars = [], []
    ii, jj = read_start, genome_start
    for s in steps:
        op, lay, xov = s & 3, (s >> 2) & 3, (s >> 4) & 1
        if op == 2:
            d_chars.append("-")
            ch = K.LS_CHARS[qr[lay, ii]]
            q_chars.append(ch.lower() if xov else ch)
            ii += 1
        elif op == 1:
            d_chars.append(K.LS_CHARS[gwin[jj]])
            q_chars.append("-")
            jj += 1
        else:
            dc = K.LS_CHARS[gwin[jj]]
            d_chars.append(dc)
            ch = K.LS_CHARS[qr[lay, ii]]
            ch = ch.lower() if xov else ch
            if ch in "nN":
                ch = dc.lower() if xov else dc
            q_chars.append(ch)
            ii += 1
            jj += 1
    return "".join(d_chars), "".join(q_chars)


# ------------------------------------------------------------- post-SW
def extract_columns(colours, initbp: int, read_start: int, dbalign: str,
                    qralign: str, pr_xover: float):
    """load_local_vectors (sw-post.c:472-551), reads without qualities:
    per column the genome letter (-1: none), the colour and its error
    rate, and the base call."""
    start_run = 0
    for j in range(read_start):
        col = int(colours[j])
        if col == K.BASE_N:
            start_run = K.BASE_N
            break
        start_run ^= col
    let, cols, err, call = [], [], [], []
    jj = read_start
    for i in range(len(dbalign)):
        if qralign[i] == "-":
            continue
        let.append(int(K.CHAR_TO_INT[ord(dbalign[i].upper())])
                   if dbalign[i] != "-" else -1)
        col = int(colours[jj])
        if (not cols and start_run == K.BASE_N) or col == K.BASE_N:
            cols.append(0)
            err.append(.75)
        else:
            cols.append(col ^ (start_run if not cols else 0))
            err.append(pr_xover)
        call.append(int(K.CHAR_TO_INT[ord(qralign[i].upper())]))
        jj += 1
    return let, cols, err, call


def forward_backward(let, cols, err, initbp: int, pr_snp: float):
    """The 16-state scaled forward-backward of sw-post.c:271-374 and the
    posteriors of post_traceback (185-210), scalar, every operation in
    the C source's order with libm's log and exp."""
    n = len(cols)
    la_match, la_mis = math.log(1 - pr_snp), math.log(pr_snp / 3.0)
    pri = []
    for i in range(n):
        lb_match, lb_mis = math.log(1 - err[i]), math.log(err[i] / 3.0)
        row = []
        for j in range(16):
            val = 0.0
            if let[i] >= 0:
                val = val - (la_match if (j & 3) == let[i] else la_mis)
            val = val - (lb_match if (((j >> 2) & 3) ^ (j & 3)) == cols[i]
                         else lb_mis)
            row.append(val)
        pri.append(row)
    fw, fws = [], []
    scale = 999999999.0
    f0 = []
    for j in range(16):
        if ((j >> 2) & 3) == initbp:
            f0.append(pri[0][j])
            scale = scale if scale < f0[j] else f0[j]
        else:
            f0.append(math.inf)
    fw.append([v - scale for v in f0])
    fws.append(scale)
    for i in range(1, n):
        E = [math.exp(-1 * v) for v in fw[i - 1]]
        S = []
        for c in range(4):
            s = 0.0
            s += E[c]
            s += E[4 + c]
            s += E[8 + c]
            s += E[12 + c]
            S.append(s)
        scale = 999999999.0
        fc = []
        for j in range(16):
            fc.append(pri[i][j] - math.log(S[(j >> 2) & 3]))
            scale = scale if scale < fc[j] else fc[j]
        fw.append([v - scale for v in fc])
        fws.append(scale + fws[i - 1])
    val = 0.0
    for v in fw[n - 1]:
        val += math.exp(-1 * v)
    total = -math.log(val) + fws[n - 1]
    bw = [None] * n
    bws = [0.0] * n
    bw[n - 1] = [0.0] * 16
    for i in range(n - 2, -1, -1):
        E2 = [math.exp(-1 * (pri[i + 1][k] + bw[i + 1][k]))
              for k in range(16)]
        scale = 999999999.0
        bc = []
        for j in range(16):
            c = j & 3
            s = 0.0
            s += E2[4 * c + 0]
            s += E2[4 * c + 1]
            s += E2[4 * c + 2]
            s += E2[4 * c + 3]
            bc.append(-math.log(s))
            scale = scale if scale < bc[j] else bc[j]
        bw[i] = [v - scale for v in bc]
        bws[i] = scale + bws[i + 1]
    post = []
    for i in range(n):
        po = [0.0] * 4
        for j in range(16):
            po[j & 3] += math.exp(-1 * (fw[i][j] + bw[i][j] + fws[i]
                                        + bws[i] - total))
        post.append(po)
    return total, post


def post_sw(h: K.Hit, r: K.Read, calib: K.Calibration) -> None:
    """post_sw (sw-post.c:469-758): letter calls, crossovers and the
    alignment's posterior; then its posterior score."""
    let, cols, err, call = extract_columns(r.codes[0], r.initbp,
                                           h.read_start, h.dbalign,
                                           h.qralign, calib.pr_xover)
    total, post = forward_backward(let, cols, err, r.initbp,
                                   calib.pr_mismatch)
    out = list(h.qralign)
    matches = mismatches = crossovers = 0
    prev, j = r.initbp, 0
    for i in range(len(out)):
        if out[i] == "-":
            continue
        p = post[j]
        crt = 0
        for k in range(1, 4):
            if p[k] > p[crt]:
                crt = k
        ch = "ACGT"[crt]
        if (prev ^ crt) == cols[j]:
            out[i] = ch
        else:
            out[i] = ch.lower()
            crossovers += 1
        if h.dbalign[i] != "-":
            if h.dbalign[i].upper() == out[i].upper():
                matches += 1
            else:
                mismatches += 1
        prev = crt
        j += 1
    res = math.exp(-total)
    db, qr = h.dbalign, h.qralign
    for i in range(len(db)):
        if db[i] == "-":
            res *= calib.pr_ins_extend
            if i == 0 or db[i - 1] != "-":
                res *= calib.pr_ins_open
        elif qr[i] == "-":
            res *= calib.pr_del_extend
            if i == 0 or qr[i - 1] != "-":
                res *= calib.pr_del_open
    h.posterior = res
    h.qralign = "".join(out)
    h.matches, h.mismatches, h.crossovers = matches, mismatches, crossovers
    a, b = calib.alpha, calib.beta
    ps = int(round(a * math.log2(h.posterior) + h.rmapped * (2 * a + b)))
    h.posterior_score = max(ps, 0)
    h.score_full = h.posterior_score
    h.pct_score_full = (1000 * 100 * h.posterior_score) // h.score_max


# ------------------------------------------------------------ the flow
def genome_planes(genome: np.ndarray):
    """Letters and colours of both strands (genome.c:1116-1126: the
    colour projection of each strand starts from an implicit T)."""
    rc = K.COMPLEMENT[genome[::-1]]

    def to_cs(c):
        prev = np.empty_like(c)
        prev[0] = 3
        prev[1:] = c[:-1]
        return K.COLOUR_MAT[prev, c]
    return genome, rc, to_cs(genome), to_cs(rc)


def vector_scores(idx, reads, hl_all, sat=None) -> dict:
    """Filter 2 in colour space over every window: the input-strand
    colours against the window of the colour plane of the window's
    strand, row 0 against COLOUR_MAT[genome letter, initial base]."""
    sc = K.CS_SCORES
    ls_f, ls_r, cs_f, cs_r = idx.planes
    L = idx.length
    rows = [(k, st, i) for k, hl2 in enumerate(hl_all) for st in (0, 1)
            for i in range(hl2[st].n)]
    if not rows:
        return {}
    G = max(int(hl_all[k][st].w_len[i]) for k, st, i in rows)
    R = max(r.read_len for r in reads)
    n = len(rows)
    gw = np.full((n, G), 254, np.uint8)
    g0 = np.full((n, G), 254, np.uint8)
    rw = np.full((n, R), 254, np.uint8)
    glen = np.zeros(n, np.int64)
    rlen = np.zeros(n, np.int64)
    for b, (k, st, i) in enumerate(rows):
        hl = hl_all[k][st]
        w = int(hl.w_len[i])
        rc = st != reads[k].input_strand
        s = L - int(hl.g_off[i]) - w if rc else int(hl.g_off[i])
        gw[b, :w] = (cs_r if rc else cs_f)[s:s + w]
        g0[b, :w] = K.COLOUR_MAT[(ls_r if rc else ls_f)[s:s + w],
                                 reads[k].initbp]
        glen[b] = w
        rw[b, :reads[k].read_len] = reads[k].codes[reads[k].input_strand]
        rlen[b] = reads[k].read_len
    v = sw.vector_scores(gw, glen, rw, rlen, sc["match"],
                         sc["match"] + sc["crossover"], sc["a_gap_open"],
                         sc["a_gap_ext"], sc["b_gap_open"], sc["b_gap_ext"],
                         sat=sat, g_row0=g0)
    return {key: int(v[b]) for b, key in enumerate(rows)}


def full_sw(idx, jobs, calib, thresholds=None) -> None:
    """Filter 3 of every job (read, hit) (hit_run_full_sw, mapping.c:
    375-379) and its post-SW (hit_run_post_sw, mapping.c:1609-1614);
    `thresholds` gives each job's full-SW threshold (%), the configured
    one where None."""
    if not jobs:
        return
    sc = K.CS_SCORES
    ls_f, ls_r = idx.planes[:2]
    n = len(jobs)
    G = max(h.w_len for _, h in jobs)
    R = max(r.read_len for r, _ in jobs)
    gwin = np.zeros((n, G), np.uint8)
    glen = np.ones(n, np.int32)
    cwin = np.full((n, R), K.BASE_N, np.uint8)
    rlen = np.ones(n, np.int32)
    initbp = np.zeros(n, np.int64)
    rect = np.zeros((n, 4), np.int64)
    rev = np.zeros(n, bool)
    xover = np.full((n, R + 1), sc["crossover"], np.int64)
    thresh = np.zeros(n, np.int64)
    aw = K.ANCHOR_WIDTH
    for b, (r, h) in enumerate(jobs):
        pct = K.SW_FULL_THRESHOLD if thresholds is None else thresholds[b]
        thresh[b] = int(K.abs_or_pct(pct, h.score_max))
        src = ls_f if h.gen_st == 0 else ls_r
        gwin[b, :h.w_len] = src[h.g_off:h.g_off + h.w_len]
        glen[b] = h.w_len
        cwin[b, :r.read_len] = r.codes[h.st]
        rlen[b] = r.read_len
        initbp[b] = r.initbp
        rect[b] = (h.ax - aw // 2, h.ay + aw // 2, h.alen, h.awid + aw)
        rev[b] = bool(h.gen_st)
    res = cs_sw.sw_full_cs_batch(
        gwin, glen, cwin, rlen, initbp, rect[:, 0], rect[:, 1],
        rect[:, 2], rect[:, 3], rev, xover, thresh, match=sc["match"],
        mismatch=sc["mismatch"], a_gap_open=sc["a_gap_open"],
        a_gap_ext=sc["a_gap_ext"], b_gap_open=sc["b_gap_open"],
        b_gap_ext=sc["b_gap_ext"], local_alignment=False,
        indel_taboo_len=0)
    for b, (r, h) in enumerate(jobs):
        score = int(res.score[b])
        h.sw_score = h.score_full = score
        h.pct_score_full = (1000 * 100 * score) // h.score_max
        if score == 0:
            continue
        h.read_start = int(res.read_start[b])
        h.genome_start = int(res.genome_start[b]) + h.g_off
        h.rmapped, h.gmapped = int(res.rmapped[b]), int(res.gmapped[b])
        h.matches, h.mismatches = int(res.matches[b]), int(res.mismatches[b])
        h.insertions = int(res.insertions[b])
        h.deletions = int(res.deletions[b])
        h.crossovers = int(res.crossovers[b])
        steps = res.steps[b, :res.n_steps[b]]
        h.ops = list((steps & 3).astype(np.int8))
        h.dbalign, h.qralign = cs_strings(steps, gwin[b], res.qr[b],
                                          h.read_start,
                                          h.genome_start - h.g_off)
        post_sw(h, r, calib)


def map_reads(idx, reads: List[K.Read], sat=None) -> List[List[str]]:
    """SAM records (without QNAME) of each read."""
    cutoff = K.list_cutoff(idx.length)
    calib = K.calibration("cs")
    hl_all = [ls.hit_lists(idx, r, cutoff, K.CS_SCORES) for r in reads]
    scores = vector_scores(idx, reads, hl_all, sat)
    pass1 = []
    jobs = []
    for k, r in enumerate(reads):
        hl2 = hl_all[k]
        scores2 = [np.array([scores[(k, st, i)] for i in range(hl2[st].n)],
                            np.int64) for st in (0, 1)]
        hits = ls.pass1(r, ls.make_hits(hl2), scores2,
                        K.CS_SW_VECT_THRESHOLD)
        for h in hits:
            ls.normalize(r, h, idx.length)
            jobs.append((r, h))
        pass1.append(hits)
    full_sw(idx, jobs, calib)
    return [[K.render(r, h, idx.contig_name, idx.length, "cs")
             for h in K.finalize(hits)] for r, hits in zip(reads, pass1)]
