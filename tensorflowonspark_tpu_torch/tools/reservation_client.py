"""Send STOP to a running rendezvous server (port of
``tools/reservation_client.py``).

The analog of the reference's ``reservation_client.py`` CLI (``:12-18``),
used to end long-running (streaming) jobs from outside the driver process.
The port's frames are byte-equal to the JAX package's, so either package's
client stops either package's server.

Usage::

    python -m tensorflowonspark_tpu_torch.tools.reservation_client HOST PORT
"""

import argparse
import logging

from tensorflowonspark_tpu_torch import reservation
from tensorflowonspark_tpu_torch.tools import setup_logging


def main(argv=None):
    setup_logging(logging.INFO)
    p = argparse.ArgumentParser(description="Stop a running cluster server")
    p.add_argument("host")
    p.add_argument("port", type=int)
    args = p.parse_args(argv)
    client = reservation.Client((args.host, args.port))
    client.request_stop()
    client.close()
    print("stop requested: {}:{}".format(args.host, args.port))


if __name__ == "__main__":
    main()
