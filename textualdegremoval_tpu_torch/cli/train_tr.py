"""TR (textual-restoration) mapper training CLI (pipeline A, stage 2).

Counterpart of textualdegremoval_tpu/cli/train_tr.py (the reference's
scripts/train/main_train_tr_mapping.py): frozen towers and the frozen I2T
mapper, the CleanMapper stacked after it trains; the CLIP view is the
degraded image, the SD target the clean one.  The reference's optimizer
trains the frozen I2T mapper instead; here, as in the JAX package, the
CleanMapper trains.  Flags as `train_i2t` (one process on one device):

    python -m textualdegremoval_tpu_torch.cli.train_tr \\
        --train_data_dir <degraded or clean images> \\
        [--train_data_dir_hq <clean images>] --output_dir <out> \\
        (--pretrained_params <dir> | --random_init) [...]
"""

from textualdegremoval_tpu_torch.cli.train_i2t import run


def main(argv=None):
    return run("tr", argv)


if __name__ == "__main__":
    main()
