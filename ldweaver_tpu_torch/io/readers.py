"""Link-table readers (reference: R/io_functions.R:13-83)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd


def read_top_hits(path: str) -> pd.DataFrame:
    """read_TopHits (R/io_functions.R:13-16)."""
    return pd.read_csv(path, sep="\t", header=0, quoting=3, comment=None)


def read_long_range_links(
    path: str, links_from_spydrpick: bool = False, sr_dist: int = 20000
) -> pd.DataFrame:
    """read_LongRangeLinks (R/io_functions.R:32-47): drops rows with
    len < sr_dist; supports SpydrPick 4/5-column space-separated files."""
    if not links_from_spydrpick:
        df = pd.read_csv(path, sep="\t", header=None, quoting=3)
        df.columns = ["pos1", "pos2", "c1", "c2", "len", "MI"]
    else:
        df = pd.read_csv(path, sep=" ", header=None, quoting=3)
        if df.shape[1] == 5:
            df.columns = ["pos1", "pos2", "len", "ARACNE", "MI"]
        elif df.shape[1] == 4:
            df.columns = ["pos1", "pos2", "len", "MI"]
    df = df[df["len"] >= sr_dist].reset_index(drop=True)
    return df


def read_short_range_links(path: str) -> pd.DataFrame:
    """read_ShortRangeLinks (R/io_functions.R:61-66)."""
    df = pd.read_csv(path, sep="\t", header=None, quoting=3)
    df.columns = [
        "clust_c",
        "pos1",
        "pos2",
        "clust1",
        "clust2",
        "len",
        "MI",
        "srp_max",
        "ARACNE",
    ]
    return df


def read_annotated_links(path: str) -> pd.DataFrame:
    """read_AnnotatedLinks (R/io_functions.R:80-83)."""
    return pd.read_csv(path, sep="\t", header=0, quoting=3)
