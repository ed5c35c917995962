"""Small-size runs of the cells for the tests."""

import time

import torch

from sortbench import cells, harness

CELLS = ["u32_256Mi_1card.full", "u32_256Mi_1card.partial_w8", "u32_1Gi_4card.lsd_w8"]
SMALL = 1 << 13  # keys a card on the CPU
SEED = 2**31 + 977  # more than 32 signed bits hold


def cpu_devices(cell):
    return [torch.device("cpu")] * cell.chips


def run_small(name, *, seed=SEED, seconds=0.2, traced=False, program=None,
              devices=None, root=cells.ROOT, keys_per_card=SMALL, **params):
    cell = cells.load(name, root, keys_per_card=keys_per_card, **params)
    devices = devices or cpu_devices(cell)
    return harness.run(cell, seed, seconds, traced, devices, time.perf_counter(),
                       program=program)
