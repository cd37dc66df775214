"""Output-directory naming grammar and its decoding (counterpart of
`crossloc_tpu/compat/naming.py`): the training and finetune CLIs encode
their flags into the output directory's name, the eval CLI's `--search_dir`
decodes them, and checkpoint-selection tooling matches the same strings."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def _run_tokens(session: str, grayscale: bool, uncertainty: Optional[str], e2e: bool,
                bf16: bool, fullsize: bool, epochs: int, learning_rate: float) -> str:
    """The tokens both grammars put after the scene, task (and encoders):
    session, "-gray", the uncertainty, "-e2e", "-bf16", "-fullsize", epochs
    and LR."""
    name = "-s" + session if session else ""
    if grayscale:
        name += "-gray"
    name += "-no_unc" if uncertainty is None else f"-unc-{uncertainty}"
    if e2e:
        name += "-e2e"
    if bf16:
        name += "-bf16"
    if fullsize:
        name += "-fullsize"
    lr_fmt = "-e{:d}-lr{:.4f}" if learning_rate >= 1e-4 else "-e{:d}-lr{:.6f}"
    return name + lr_fmt.format(epochs, learning_rate)


def _real_tokens(real_only: bool, real_data_domain: str, real_data_chunk: float,
                 pairs: str) -> str:
    """"-real_only" or the pairwise token, the domain and the real chunk."""
    name = "-real_only" if real_only else pairs
    if real_data_domain == "in_place":
        name += "-ip"
    elif real_data_domain == "out_of_place":
        name += "-oop"
    else:
        raise NotImplementedError(real_data_domain)
    return name + "-rc{:.2f}".format(real_data_chunk)


def train_output_name(scene: str, task: str, session: str = "", grayscale: bool = False,
                      uncertainty: Optional[str] = None, fullsize: bool = False,
                      epochs: int = 50, learning_rate: float = 2e-4,
                      real_data_chunk: float = 1.0, sim_data_chunk: float = 1.0,
                      real_data_domain: str = "in_place", real_only: bool = False,
                      tiny: bool = False, network_in: Optional[str] = None, debug: bool = False,
                      e2e: bool = False, bf16: bool = False) -> str:
    """The reference training CLI's output-directory name; `e2e` and `bf16`
    add "-e2e" and "-bf16" after the uncertainty token, as in the JAX
    package."""
    name = f"{scene}-{task}" + _run_tokens(session, grayscale, uncertainty, e2e, bf16, fullsize,
                                           epochs, learning_rate)
    if real_data_chunk == 0.0:
        if sim_data_chunk <= 0:
            raise ValueError("one of real/sim chunks must be positive")
        name += "-sim_only" + "-sc{:.2f}".format(sim_data_chunk)
    else:
        name += _real_tokens(real_only, real_data_domain, real_data_chunk, "-pairs")
    if tiny:
        name += "-tiny"
    if network_in is not None:
        name += "-finetune"
    if debug:
        name += "-DEBUG"
    return name


def finetune_output_name(scene: str, task: str, encoders: Sequence[str],
                         reuse_coord_encoder: bool = False, unfreeze_coord_encoder: bool = False,
                         session: str = "", grayscale: bool = False,
                         uncertainty: Optional[str] = None, fullsize: bool = False,
                         epochs: int = 50, learning_rate: float = 1e-4,
                         real_data_chunk: float = 1.0, sim_data_chunk: float = 0.0,
                         real_data_domain: str = "in_place", real_only: bool = False,
                         tiny: bool = False, network_in: Optional[str] = None,
                         debug: bool = False, e2e: bool = False, bf16: bool = False) -> str:
    """The decoder-finetune CLI's output-directory name: "-decoder_" and the
    encoders, the reused coord encoder marked "_coord_free_" or
    "_coord_frozen_" (dropped when not reused), "-zero_shot" for a session
    holding "-ft0.00", "-pairwise" for real data, "-resume" with
    `--network_in`; otherwise the training grammar's tokens."""
    name = f"{scene}-{task}-decoder_" + "_".join(encoders)
    if reuse_coord_encoder:
        name = name.replace("_coord_",
                            "_coord_free_" if unfreeze_coord_encoder else "_coord_frozen_")
    else:
        name = name.replace("_coord_", "_")
    name += _run_tokens(session, grayscale, uncertainty, e2e, bf16, fullsize, epochs,
                        learning_rate)
    if real_data_chunk == 0.0:
        if sim_data_chunk <= 0:
            raise ValueError("one of real/sim chunks must be positive")
        name += "-zero_shot" if "-ft0.00" in session else "-sim_only"
        name += "-sc{:.2f}".format(sim_data_chunk)
    else:
        if sim_data_chunk != 0.0:
            raise ValueError("pairwise fine-tuning disables LHS sim data")
        name += _real_tokens(real_only, real_data_domain, real_data_chunk, "-pairwise")
    if tiny:
        name += "-tiny"
    if network_in is not None:
        name += "-resume"
    if debug:
        name += "-DEBUG"
    return name


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
