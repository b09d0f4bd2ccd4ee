"""Least work of one ``gram_conditional`` launch (ops/step.py ->
csrc/step.cu): fk = (phi x phi) P_k, 2 r^2 n products a row on the
tensor cores and r^2 outer-product operations; phi and P read once, fk
written once.  A frozen copy of chip_smoke.py's phase-8 arithmetic."""


def work(rows: int, n: int, r: int) -> dict:
    return {"tc_flops": rows * 2 * r * r * n,
            "flops": rows * r * r,
            "bytes": 4 * (rows * (r + n) + r * r * n)}
