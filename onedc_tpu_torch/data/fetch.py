"""Dataset fetch helper (the reference's ``src/get_cc_dataset.py``).

JAX counterpart: ``onedc_tpu/data/fetch.py``. Downloads the CommonCanvas
CC-BY-ND shards through HF ``datasets`` (imported here only) where the
machine has network access and the package; without them, point
``CommonCanvasDataset`` at a local ``save_to_disk`` directory instead.

  python -m onedc_tpu_torch.data.fetch --out_dir DIR [--name N --split S]
"""

from __future__ import annotations

import argparse


def fetch_common_canvas(out_dir: str,
                        name: str = "common-canvas/commoncatalog-cc-by-nd",
                        split: str = "train"):
    import datasets

    ds = datasets.load_dataset(name, split=split)
    ds.save_to_disk(out_dir)
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out_dir", required=True)
    p.add_argument("--name", default="common-canvas/commoncatalog-cc-by-nd")
    p.add_argument("--split", default="train")
    a = p.parse_args(argv)
    fetch_common_canvas(a.out_dir, a.name, a.split)


if __name__ == "__main__":
    main()
