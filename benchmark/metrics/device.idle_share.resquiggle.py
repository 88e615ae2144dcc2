"""Share, in %, of the traced window in which no kernel, copy or set ran on
the card, read as `device.idle_share.basic` reads it, in the resquiggle
cell."""

import os

from benchmark.harness.main import load_file

read = load_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "device.idle_share.basic.py"),
                 "bench_metric_device_idle_share_basic").read
