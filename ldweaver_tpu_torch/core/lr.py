"""Long-range link analysis (SpydrPick-equivalent path).

Reference: `analyse_long_range_links` (R/lr_analyser.R:30-187):
  * Tukey outlier thresholds q75 + {1.5, 3} * IQR over LR MI (:72-74)
  * fallback to ~top-5000 links when < 5000 outliers (:92-97)
  * ARACNE over the combined sr+lr pool above the lower threshold (:101-108)
  * descending-MI ordering (:112-115)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import pandas as pd

from ldweaver_tpu_torch.core.aracne import run_aracne
from ldweaver_tpu_torch.utils.r_compat import quantile_type7


@dataclasses.dataclass
class LrAnalysis:
    links: pd.DataFrame  # reduced, ARACNE-labelled, MI-descending
    thresholds: Tuple[float, float]
    used_fallback: bool


def analyse_long_range_links_core(
    lr_links: pd.DataFrame,
    sr_links: Optional[pd.DataFrame],
    are_lrlinks_ordered: bool = False,
) -> LrAnalysis:
    """Threshold + ARACNE + ordering on already-loaded link tables.

    lr_links needs columns pos1,pos2,len,MI (c1/c2 optional);
    sr_links (may be None) needs pos1,pos2,MI.
    """
    q13 = quantile_type7(lr_links["MI"].to_numpy(), [0.25, 0.75])  # :72
    iqr = q13[1] - q13[0]
    thresholds = (q13[1] + 1.5 * iqr, q13[1] + 3.0 * iqr)  # :74

    red = lr_links[lr_links["MI"] > min(thresholds)].copy()  # :89
    used_fallback = False
    if len(red) < 5000 and len(lr_links) >= 5000:  # :92
        n = len(lr_links)
        probs = 1.0 - (1.0 / n) * np.array([4000.0, 5000.0])  # :95
        th = quantile_type7(lr_links["MI"].to_numpy(), probs)
        thresholds = (float(th.min()), float(th.max()))
        red = lr_links[lr_links["MI"] > min(thresholds)].copy()
        used_fallback = True

    if "ARACNE" not in red.columns:  # :101 (spydrpick input may carry it)
        pool_pos1 = [lr_links["pos1"].to_numpy()]
        pool_pos2 = [lr_links["pos2"].to_numpy()]
        pool_mi = [lr_links["MI"].to_numpy()]
        if sr_links is not None and len(sr_links) > 0:
            pool_pos1.append(sr_links["pos1"].to_numpy())
            pool_pos2.append(sr_links["pos2"].to_numpy())
            pool_mi.append(sr_links["MI"].to_numpy())
        p1 = np.concatenate(pool_pos1)
        p2 = np.concatenate(pool_pos2)
        mi = np.concatenate(pool_mi)
        keep = mi > min(thresholds)  # :106
        labels = run_aracne(
            red["pos1"].to_numpy(),
            red["pos2"].to_numpy(),
            red["MI"].to_numpy(),
            p1[keep],
            p2[keep],
            mi[keep],
        )
        red["ARACNE"] = labels.astype(np.int64)

    if not are_lrlinks_ordered:  # :112-115
        red = red.sort_values("MI", ascending=False, kind="stable").reset_index(
            drop=True
        )
    return LrAnalysis(links=red, thresholds=thresholds, used_fallback=used_fallback)
