"""The yardstick of the kernel roofline shares: the card's peaks and the
work of each algorithm stage per DP cell.

Peaks of one NVIDIA H100 SXM (80 GB HBM3) at its full 700 W limit:
3.35 TB/s of HBM bandwidth (NVIDIA's data sheet). The data sheet gives
no int32 rate; the 67 TFLOP/s of float32 outside the tensor cores count
an FMA as two operations on 128 lanes an SM, and int32 issues on 64 lanes
an SM, so the int32 rate is derived as a quarter of it. The harness
prints the card's power limit beside every share.
"""
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4    # derived, not published

# int32 operations per DP cell of each stage's recurrence, frozen from
# the kernels of the port as the benchmark was defined: the vector SW
# (filter 2) keeps H, E, F and the best score; the letter-space full SW
# (filter 3) adds the three planes' backpointers (40 with the traceback-
# free statistics, 32 with stored backpointers); the colour-space DP
# runs four layers. Traceback walks count no operations: their time
# counts, their work does not, so a share is never counted high.
OPS_PER_CELL = {"vector": 14, "ls_stats": 40, "ls_bp": 32, "ls_tb": 0,
                "cs_dp": 240, "cs_tb": 0}
