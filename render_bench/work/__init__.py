"""The yardstick of the rooflines: the card's published peak and the bytes
each hand-written kernel's work must move, counted from the cell's sizes
alone (frozen here so that a change to the program cannot move them).

Both counts are floors, not tight bounds: each byte a frame must write or
read once, none of what a kernel reads again or spills. So a kernel's share
of its roofline is at most 100% and in practice well below it.
"""

# NVIDIA H100 SXM5 (80 GB HBM3), NVIDIA's data sheet: HBM bandwidth.
HBM_BYTES_PER_S = 3.35e12
