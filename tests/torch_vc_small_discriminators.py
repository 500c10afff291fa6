"""``satpu_torch.bin.train_vc`` with the discriminators shrunk as the GAN
tests shrink them (the CLI has satpu's options only): run as a script,
e.g. under ``torch.distributed.run``, with train_vc's arguments."""
import functools
import sys

from satpu_torch.bin import train_vc
from satpu_torch.hifigan import trainer

if __name__ == "__main__":
    trainer.GanHparams = functools.partial(trainer.GanHparams, mpd_periods=(2,), msd_scales=2,
                                           disc_channel_scale=1 / 16)
    sys.exit(train_vc.main(sys.argv[1:]))
