"""Build and checkpoint a signed distance field.

Port of examples/save_sdf.py (SaveSDFExample.m, the Boost-serialization
save of the WAMDeskDataset SDF): builds the field with the native EDT,
saves it to an .npz archive (the format both packages read) in a temporary
directory and loads it back, on the card unless --cpu.

Run: python examples_torch/save_sdf.py [--cpu]
"""

import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpmp2_tpu_torch.datasets import generate_3d_dataset, sdf_from_occupancy  # noqa: E402
from gpmp2_tpu_torch.device import resolve_device  # noqa: E402
from gpmp2_tpu_torch.obstacle import sdf_lookup  # noqa: E402
from gpmp2_tpu_torch.utils import load_sdf, save_sdf  # noqa: E402


def main():
    dev = torch.device("cpu") if "--cpu" in sys.argv else resolve_device()
    print("building WAMDeskDataset SDF (native EDT) ...")
    ds = generate_3d_dataset("WAMDeskDataset")
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, device=dev)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wam_desk_sdf.npz")
        save_sdf(path, sdf)
        print(f"saved {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
        sdf2 = load_sdf(path, device=dev)

    q = torch.tensor([[0.2, 0.7, -0.2]], device=dev)  # inside the desk top
    d1, _, _ = sdf_lookup(sdf, q)
    d2, _, _ = sdf_lookup(sdf2, q)
    print(f"lookup before/after round trip: {float(d1[0]):.4f} / {float(d2[0]):.4f}")
    assert abs(float(d1[0]) - float(d2[0])) < 1e-6
    print("round trip OK")


if __name__ == "__main__":
    main()
