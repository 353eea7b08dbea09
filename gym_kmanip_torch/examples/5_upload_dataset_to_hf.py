"""Push a recorded HDF5 dataset to the HuggingFace hub.

Port of `gym_kmanip_tpu/examples/5_upload_dataset_to_hf.py`: lerobot's
`push_dataset_to_hub` with the aloha_hdf5 raw format, which reads the ACT
layout that log/log_h5py.py writes. lerobot is optional and the upload
needs the network; `main()` raises without lerobot.

    HF_USER=... KMANIP_DATASET=... python -m gym_kmanip_torch.examples.5_upload_dataset_to_hf
"""

import os

from gym_kmanip_torch import constants as k


def main():
    try:
        from lerobot.scripts.push_dataset_to_hub import push_dataset_to_hub
    except ImportError:
        raise SystemExit("lerobot is not installed; install it on a network-connected "
                         "machine to upload datasets.")
    push_dataset_to_hub(
        data_dir=os.environ.get("KMANIP_DATA_DIR", k.DATA_DIR),
        dataset_id=os.environ.get("KMANIP_DATASET", "test"),
        raw_format="aloha_hdf5",
        community_id=os.environ.get("HF_USER", "kscale"),
        fps=k.FPS,
        video=False,
    )


if __name__ == "__main__":
    main()
