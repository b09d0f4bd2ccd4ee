"""Least work of one ``condition_update`` launch (ops/step.py ->
csrc/step.cu): phi' = phi (la C[i0] + lb C[i0+1]), renormalised, 5 r^2 +
2 r operations a row, none on the tensor cores; phi, i0, la, lb and the
core read once, phi' written once.  A frozen copy of chip_smoke.py's
phase-8 arithmetic."""


def work(rows: int, n: int, r: int) -> dict:
    return {"tc_flops": 0,
            "flops": rows * (5 * r * r + 2 * r),
            "bytes": 4 * (rows * (2 * r + 3) + n * r * r)}
