"""Input-file generator (reference ``schrodinger_equation/input.py``).

Builds a reference-format ``input`` file for the exact solvers / GPLE run from
a target ln(E): p0 = sqrt(2 m E), sigma_p = p0 / 20, output time chosen with
the 1-2-5 cutoff so the run produces about ``number_of_output`` frames.
"""

from __future__ import annotations

import math


def cutoff_125(x: float) -> float:
    """Round to the nearest {1, 2, 5} x 10^N from above (reference input.py:29-44)."""
    logx = math.log10(x)
    # floor, not int(): the reference's int() truncates toward zero and
    # misrounds sub-unity values (never hit in its usage)
    n = math.floor(logx)
    powx = 10.0 ** n
    resume = logx - n
    if resume < math.log10(2.0):
        return 2 * powx
    if resume < math.log10(5.0):
        return 5 * powx
    return 10 * powx


def generate_input(
    ln_energy: float,
    path: str = "input",
    mass: float = 2000.0,
    x0: float = -8.0,
    dt_max: float = 0.1,
    number_of_output: int = 50,
    num_points: int = 1024,
) -> dict:
    """Write the 8-field GPLE ``input`` file for a given ln(E); returns the
    field values."""
    p0 = math.sqrt(2.0 * mass * math.exp(ln_energy))
    sigma_p = p0 / 20.0
    total_time = (-x0 - x0) / (p0 / mass)
    output_time = cutoff_125(total_time / number_of_output)
    fields = dict(
        mass=mass, x0=x0, p0=p0, sigma_p0=sigma_p,
        output_time=output_time, reopt_time=output_time,
        dt=dt_max, num_points=num_points,
    )
    with open(path, "w") as f:
        f.write(
            f"""mass:
{mass}
x0:
{x0}
p0:
{p0}
sigma_p0:
{sigma_p}
output time:
{output_time}
reopt time:
{output_time}
dt:
{dt_max}
number of points:
{num_points}
"""
        )
    return fields
