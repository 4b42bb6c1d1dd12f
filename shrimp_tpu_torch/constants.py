"""Base encodings, score defaults and seed sets for shrimp-tpu.

Behavioral reference: SHRiMP2 v2.2.3 (compbio-UofT/shrimp).
- 4-bit base codes:          common/fasta.h:26-56
- char <-> code maps:        common/fasta.c:28-58
- complement table:          common/util.h:125-151
- colour-space matrix:       common/util.h:182-207
- score/threshold defaults:  gmapper/gmapper-defaults.h:44-72
- default spaced seed sets:  gmapper/gmapper-defaults.h:194-238

Copied from `shrimp_tpu/constants.py` unchanged: the port keeps its own
copy of the JAX package's host modules and imports none of them.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- base codes
BASE_A, BASE_C, BASE_G, BASE_T, BASE_U = 0, 1, 2, 3, 4
BASE_M, BASE_R, BASE_W, BASE_S, BASE_Y, BASE_K = 5, 6, 7, 8, 9, 10
BASE_V, BASE_H, BASE_D, BASE_B = 11, 12, 13, 14
BASE_X = BASE_N = 15

LS_INT_TO_CHAR = np.frombuffer(b"ACGTUMRWSYKVHDBN", dtype=np.uint8)
CS_INT_TO_CHAR = np.frombuffer(b"0123!@#$%^&*?~;N", dtype=np.uint8)
# base_translate uses '.' for BASE_N in colour space (fasta.c:684)
CS_INT_TO_CHAR_DOT = np.frombuffer(b"0123!@#$%^&*?~;.", dtype=np.uint8)

# char -> 4-bit code; -1 = invalid (fasta.c:28-42)
CHAR_TO_INT = np.full(256, -1, dtype=np.int16)
for _i, _c in enumerate("ACGTUMRWSYKVHDBN"):
    CHAR_TO_INT[ord(_c)] = _i
    CHAR_TO_INT[ord(_c.lower())] = _i
CHAR_TO_INT[ord("X")] = BASE_X
CHAR_TO_INT[ord("x")] = BASE_X
for _c, _v in zip("0123", (BASE_A, BASE_C, BASE_G, BASE_T)):
    CHAR_TO_INT[ord(_c)] = _v
CHAR_TO_INT[ord(".")] = BASE_N
CHAR_TO_INT[ord("4")] = BASE_N
CHAR_TO_INT[ord("N")] = BASE_N  # (already set, kept for clarity)

# complement_base (util.h:128-145); RNA handling applied separately
COMPLEMENT = np.array(
    [BASE_T, BASE_G, BASE_C, BASE_A, BASE_A, BASE_K, BASE_Y, BASE_W,
     BASE_S, BASE_R, BASE_M, BASE_B, BASE_D, BASE_H, BASE_V, BASE_N],
    dtype=np.uint8)

# lstocs colour matrix (util.h:185-190); anything > BASE_T maps to N
_CS = np.full((16, 16), BASE_N, dtype=np.uint8)
_CS[:4, :4] = np.array([[0, 1, 2, 3], [1, 0, 3, 2], [2, 3, 0, 1], [3, 2, 1, 0]],
                       dtype=np.uint8)
COLOUR_MAT = _CS

MODE_LETTER_SPACE = "ls"
MODE_COLOUR_SPACE = "cs"

# ---------------------------------------------------------------- defaults
DEF_LS_MATCH_SCORE = 10
DEF_LS_MISMATCH_SCORE = -15
DEF_LS_A_GAP_OPEN = -33
DEF_LS_B_GAP_OPEN = -33
DEF_LS_A_GAP_EXTEND = -7
DEF_LS_B_GAP_EXTEND = -3

DEF_CS_MATCH_SCORE = 10
DEF_CS_MISMATCH_SCORE = -24
DEF_CS_XOVER_SCORE = -20
DEF_CS_A_GAP_OPEN = -33
DEF_CS_B_GAP_OPEN = -33
DEF_CS_A_GAP_EXTEND = -7
DEF_CS_B_GAP_EXTEND = -3

DEF_WINDOW_GEN_THRESHOLD = 55.0
DEF_SW_VECT_THRESHOLD = 47.0
DEF_SW_FULL_THRESHOLD = 50.0
DEF_WINDOW_LEN = 140.0
DEF_WINDOW_OVERLAP = 90.0
DEF_NUM_OUTPUTS = 10
DEF_ANCHOR_WIDTH = 8
DEF_MATCH_MODE_UNPAIRED = 2
DEF_MATCH_MODE_PAIRED = 4
DEF_LONGEST_READ_LENGTH = 1000
DEF_LS_QUAL_DELTA = 64
DEF_CS_QUAL_DELTA = 33

DEF_REGION_BITS = 11
DEF_REGION_OVERLAP = 50
DEF_ANCHOR_LIST_BIG_GAP = 1024

DEF_MIN_INSERT_SIZE = 0
DEF_MAX_INSERT_SIZE = 1000
DEF_INSERT_SIZE_MEAN = 200
DEF_INSERT_SIZE_STDDEV = 100

PAIR_NONE = "none"
PAIR_OPP_IN = "opp-in"
PAIR_OPP_OUT = "opp-out"
PAIR_COL_FW = "col-fw"
PAIR_COL_BW = "col-bw"
PAIR_MODES = (PAIR_NONE, PAIR_OPP_IN, PAIR_OPP_OUT, PAIR_COL_FW, PAIR_COL_BW)
# pair_reverse strand pre-flip table (gmapper-defaults.h:184-191)
PAIR_REVERSE = {
    PAIR_NONE: (False, False),
    PAIR_OPP_IN: (False, False),
    PAIR_OPP_OUT: (True, True),
    PAIR_COL_FW: (False, True),
    PAIR_COL_BW: (True, False),
}

# default spaced seeds (gmapper-defaults.h:194-238); LS == CS sets in 2.2.3
DEFAULT_SEEDS = {
    10: ["111110011111", "111100110001111", "111100100100100111",
         "111001000100001001111"],
    11: ["1111001111111", "1111100110001111", "11110010010001001111",
         "11100110010000100100111"],
    12: ["11110111101111", "1111011100100001111", "1111000011001101111"],
    16: ["111111101110111111", "1111100101101101011111",
         "11110011001010100011011111", "111101001100000100110011010111"],
    18: ["11111011111110111111", "11110111011010111011111",
         "11111100110101101001011111", "11111010101100100010011101111"],
}
DEFAULT_SEED_WEIGHT = 12

MIRNA_SEEDS = [
    "00111111001111111100",
    "00111111110011111100",
    "00111111111100111100",
    "00111111111111001100",
    "00111111111111110000",
]

MAX_SEED_SPAN = 64
MAX_SEED_WEIGHT = 14
HASH_TABLE_POWER = 12
