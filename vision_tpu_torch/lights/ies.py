"""IES photometric profiles (IESNA LM-63).

Counterpart of `vision_tpu/lights/ies.py`: reads a candela distribution
over a (vertical, horizontal) angle grid and resamples it on the host, in
float64, to a regular polar table (azimuthally averaged, peak 1, float32)
that a spot or projector light multiplies its output by.
"""
from __future__ import annotations

import numpy as np
import torch


class IESProfile:
    def __init__(self, v_angles, h_angles, candela):
        self.v_angles = np.asarray(v_angles, np.float64)
        self.h_angles = np.asarray(h_angles, np.float64)
        self.candela = np.asarray(candela, np.float64)  # [H, V]
        self.max_candela = float(self.candela.max()) if self.candela.size else 1.0

    @classmethod
    def parse(cls, text):
        """Parse LM-63 text (1991 / 1995 / 2002 headers; TILT=NONE or
        INCLUDE, whose tilt table is skipped)."""
        lines = text.splitlines()
        i = 0
        while i < len(lines) and not lines[i].strip().upper().startswith("TILT"):
            i += 1
        if i >= len(lines):
            raise ValueError("not an IES file (no TILT line)")
        tilt = lines[i].split("=", 1)[-1].strip().upper()
        i += 1
        if tilt == "INCLUDE":
            # lamp-to-luminaire geometry, the pair count, angles, factors
            nums = []
            while i < len(lines) and len(nums) < 2:
                nums += lines[i].split()
                i += 1
            need = 2 * int(float(nums[1]))
            got = len(nums) - 2
            while i < len(lines) and got < need:
                got += len(lines[i].split())
                i += 1
        vals = []
        for line in lines[i:]:
            vals += [float(v) for v in line.replace(",", " ").split()]
        if len(vals) < 13:
            raise ValueError("truncated IES data")
        # [0] lamps [1] lumens per lamp [2] multiplier [3] vertical angles
        # [4] horizontal angles [5] photometric type [6] units [7:10] size
        # [10:13] ballast factor, future use, input watts
        mult = vals[2]
        n_v = int(vals[3])
        n_h = int(vals[4])
        data = vals[13:]
        v_angles = np.asarray(data[:n_v])
        h_angles = np.asarray(data[n_v:n_v + n_h])
        cd = np.asarray(data[n_v + n_h:n_v + n_h + n_v * n_h]) * mult
        return cls(v_angles, h_angles, cd.reshape(n_h, n_v))

    @classmethod
    def load(cls, path):
        with open(path, "r", errors="ignore") as f:
            return cls.parse(f.read())

    def to_table(self, n_theta=64):
        """The profile on n_theta polar angles over [0, 180] degrees,
        averaged over the horizontal angles, normalised to peak 1: float32
        numpy [n_theta]."""
        thetas = np.linspace(0.0, 180.0, n_theta)
        prof = np.mean([np.interp(thetas, self.v_angles, row, left=row[0],
                                  right=row[-1]) for row in self.candela],
                       axis=0)
        return (prof / max(prof.max(), 1e-9)).astype(np.float32)


def eval_ies(table, cos_theta):
    """The attenuation of `to_table` profiles at cos_theta from the light's
    principal direction, linear in the polar angle: `table` is one profile
    [n] or one per lane [..., n] for cos_theta [...]."""
    n = table.shape[-1]
    theta = torch.rad2deg(torch.arccos(torch.clamp(cos_theta, -1.0, 1.0)))
    t = theta / 180.0 * (n - 1)
    i0 = torch.clamp(t.to(torch.int32), 0, n - 1).long()
    i1 = torch.clamp(i0 + 1, 0, n - 1)
    f = (t - i0.to(torch.float32))[..., None]
    rows = table.expand(cos_theta.shape + (n,))
    v0 = torch.gather(rows, -1, i0[..., None])
    v1 = torch.gather(rows, -1, i1[..., None])
    return (v0 * (1 - f) + v1 * f)[..., 0]
