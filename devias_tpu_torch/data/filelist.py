"""CSV filelist parsing for every dataset family.

Formats (space-delimited, no header; ref dataset/kinetics.py:47-74,
dataset/hvu.py:47-50, dataset/activitynet.py:51-56):

  standard:    <relpath> <label>
  with-length: <relpath> <video_len> <label>          (SCUBA / *-BG frame dirs)
  hvu:         <name> <action_label> <scene_label>    ('.mp4' appended)
  activitynet: <name> <start> <end> <duration> <label>
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional


@dataclasses.dataclass
class FilelistEntry:
    path: str
    label: int = -1
    video_len: Optional[int] = None
    scene_label: Optional[int] = None
    start: Optional[float] = None
    end: Optional[float] = None
    duration: Optional[float] = None


def read_filelist(
    anno_path: str,
    data_path: str = "",
    fmt: str = "standard",
    path_prefix: str = "",
    suffix: str = "",
) -> List[FilelistEntry]:
    entries: List[FilelistEntry] = []
    with open(anno_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(" ")
            if fmt == "standard":
                # paths may contain spaces: label is the last token
                path, label = " ".join(parts[:-1]), int(parts[-1])
                entries.append(
                    FilelistEntry(
                        path=os.path.join(data_path, path_prefix, path + suffix),
                        label=label,
                    )
                )
            elif fmt == "with_length":
                path, vlen, label = " ".join(parts[:-2]), int(parts[-2]), int(parts[-1])
                entries.append(
                    FilelistEntry(
                        path=os.path.join(data_path, path_prefix, path + suffix),
                        label=label,
                        video_len=vlen,
                    )
                )
            elif fmt == "hvu":
                path, action, scene = " ".join(parts[:-2]), int(parts[-2]), int(parts[-1])
                entries.append(
                    FilelistEntry(
                        path=os.path.join(data_path, path_prefix, path + (suffix or ".mp4")),
                        label=action,
                        scene_label=scene,
                    )
                )
            elif fmt == "activitynet":
                name = " ".join(parts[:-4])
                start, end, duration = (float(x) for x in parts[-4:-1])
                label = int(parts[-1])
                entries.append(
                    FilelistEntry(
                        path=os.path.join(data_path, path_prefix, name + suffix),
                        label=label,
                        start=start,
                        end=end,
                        duration=duration,
                    )
                )
            else:
                raise ValueError(f"unknown filelist format {fmt}")
    return entries
