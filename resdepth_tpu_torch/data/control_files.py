"""Control-file IO: imagelists, pairlists, normalization parameters.

Parity with the reference's lib/io_control_file.py:5-123, with one
modernisation: normalization parameters are written as JSON (human-readable,
pickle-free) while the reference's pickle format is still READ transparently
so reference training artifacts remain usable for inference.

The port's copy of ``resdepth_tpu/data/control_files.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import json
import pickle

from resdepth_tpu_torch.utils import fs
from resdepth_tpu_torch.utils.logging import setup_logger


def read_normalization_params_from_file(filepath: str) -> dict:
    """Read {mean, std} normalization parameters (JSON or reference pickle)."""
    if fs.file_extension(filepath) == ".json":
        with open(filepath) as fid:
            return json.load(fid)
    with open(filepath, "rb") as fid:
        return pickle.load(fid)


def write_normalization_params_to_file(filepath: str, mean, std) -> None:
    """Write {mean, std} normalization parameters.

    JSON when the path ends in .json (framework default), reference-compatible
    pickle otherwise (so reference test.py can consume our training runs).
    """
    params = {"mean": mean, "std": std}
    if fs.file_extension(filepath) == ".json":
        with open(filepath, "w") as fid:
            json.dump(params, fid, indent=2)
    else:
        with open(filepath, "wb") as fid:
            pickle.dump(params, fid, protocol=pickle.HIGHEST_PROTOCOL)


def read_imagelist_from_file(file: str) -> list[str]:
    """Read a text file listing image paths, one per line."""
    with open(file) as fid:
        return fid.read().splitlines()


def read_pairlist_from_file(file_imagelist: str, file_pairlist: str, logger=None):
    """Parse an image-pair list against an imagelist.

    Each pairlist line is a comma-separated list of image *names* (substrings
    of the imagelist paths); returns ``(image_list, image_pairs)`` where
    ``image_pairs`` is a list of equal-arity index tuples, or ``None`` on any
    of the reference's error conditions (ragged arities, missing/ambiguous
    names, duplicate images within a pair, duplicate pairs) — see
    lib/io_control_file.py:51-123.
    """
    if logger is None:
        logger = setup_logger("read_pairlist_from_file", log_to_console=True, log_file=None)

    image_list = read_imagelist_from_file(file_imagelist)

    with open(file_pairlist) as fid:
        pair_names = [line.split(", ") for line in fid.read().splitlines() if line]

    if len({len(pair) for pair in pair_names}) not in (0, 1):
        logger.error(f"Varying number of images per image pair detected in {file_pairlist}.\n")
        return image_list, None

    image_pairs: list[tuple[int, ...]] = []
    for pair in pair_names:
        indices: list[int] = []
        for image in pair:
            matches = [i for i, path in enumerate(image_list) if image in path]
            if len(matches) > 1:
                logger.error(f"Found the image {image} multiple times in {file_imagelist}.\n")
                return image_list, None
            if len(matches) == 0:
                logger.error(f"The image {image} is not listed in {file_imagelist}.\n")
                return image_list, None
            if matches[0] in indices:
                logger.error(f"Found the image {image} multiple times within the same "
                             f"image pair in {file_imagelist}.\n")
                return image_list, None
            indices.append(matches[0])

        if tuple(indices) in image_pairs:
            logger.error(f"Found the image pair {tuple(indices)} multiple times "
                         f"in {file_imagelist}.")
            return image_list, None
        image_pairs.append(tuple(indices))

    return image_list, image_pairs
