"""Offline MRI preprocessing of the port: NIfTI -> slices -> captions ->
labels -> splits, with no PIL and no pandas (counterpart of
`mrclip_tpu/preprocessing`). Run as a pipeline via
`python -m mrclip_tpu_torch.preprocessing`.
"""

from .binning import (
    DROP_FLIP_ANGLES,
    MODEL_NAME_MAPPING,
    get_bin_label,
    label_rows,
    load_bin_intervals,
    make_label_string,
    parse_dicom_metadata,
)
from .captions import (
    build_caption_rows,
    extract_slice_number,
    generate_text_from_json,
    simplify_text,
    slice_range_for_plane,
)
from .nifti import determine_plane, process_nifti, read_nifti, volume_to_slices, write_nifti
from .split import extract_image_id, filter_slices, merge_and_shuffle_split
