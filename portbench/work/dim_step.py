"""Least work of one ``dim_step`` launch (ops/dim_step.py ->
csrc/dim_step.cu): the conditional phi B (n r^2 multiply-adds a row, the
tensor cores' part) and its squares (n r), the prefix update (r^2
interpolations and r^2 multiply-adds), about 6n CDF operations a row;
every input byte read once (phi, two seeds, B, C, the spacings and the
grid pair) and every output byte written once (phi', nine scalars).
A frozen copy of chip_smoke.py's phase-4 arithmetic."""


def work(rows: int, n: int, r: int) -> dict:
    return {"tc_flops": rows * 2 * n * r * r,
            "flops": rows * (2 * n * r + 5 * r * r + 6 * n),
            "bytes": 4 * (rows * r + 2 * rows + r * n * r + n * r * r
                          + (n - 1) + 2 * n + rows * r + 9 * rows)}
