"""Output-folder metadata decoding (counterpart of
`crossloc_tpu/compat/naming.py::read_meta_info`), used by the eval CLI's
`--search_dir`."""
from __future__ import annotations

from typing import List, Optional, Tuple


def read_meta_info(folder_name: str) -> Tuple[str, bool, str, List[str], bool, bool, Optional[str]]:
    """Decode (scene, grayscale, task, sections, tiny, fullsize, uncertainty)
    from an output folder name."""
    if "no_unc" in folder_name:
        uncertainty = None
    elif "unc-MLE" in folder_name:
        uncertainty = "MLE"
    else:
        raise NotImplementedError("unknown uncertainty keyword in " + folder_name)

    scene = folder_name.split("-")[0]
    grayscale = "-gray" in folder_name
    task = folder_name.split("-")[1]

    if "decoder" in folder_name:
        if "-oop-" in folder_name:
            section = ["test_oop_drone_real"]
        elif "-ip-" in folder_name:
            section = ["test_drone_real"]
        else:
            raise NotImplementedError("unknown domain keyword in " + folder_name)
    else:
        section = ["val_drone_sim", "val_drone_real"]

    tiny = "-tiny" in folder_name
    fullsize = "-fullsize" in folder_name or "-semantics" in folder_name
    return scene, grayscale, task, section, tiny, fullsize, uncertainty
