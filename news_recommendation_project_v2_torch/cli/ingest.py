"""Ingest CLI: MIND's raw TSVs -> the port's processed store (pandas and
pyarrow not needed).

    nrtorch-ingest DATA_DIR MINDsmall_train
    nrtorch-ingest DATA_DIR MINDsmall_train --synthetic   # write a small synthetic raw split first
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..config import NewsDataset
from ..data.ingest import store_processed_data


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("news_dataset", choices=NewsDataset._member_names_)
    parser.add_argument(
        "--synthetic",
        action="store_true",
        help="generate a synthetic raw MIND fixture first (offline testing)",
    )
    args = parser.parse_args(argv)
    dataset = NewsDataset[args.news_dataset]
    if args.synthetic:
        from ..data.synthetic import write_synthetic_mind

        write_synthetic_mind(args.data_dir, dataset)
    out = store_processed_data(args.data_dir, dataset)
    print(f"processed data written to {out}")


if __name__ == "__main__":
    main()
