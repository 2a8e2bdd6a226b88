"""Resource axis counts (copied from the reference's api/resource.py).

Axes are ``[cpu, memory, gpu, volume attachments]``; the first three are
the fairness set (DRF / proportion), the last is fit-only.
"""
NUM_RESOURCES = 4
NUM_FAIR_RESOURCES = 3
