"""``python -m repro_torch.remote`` — serve a directory of BasketFiles.

Quickstart::

    PYTHONPATH=src python -m repro_torch.remote /data/shards --port 9147
    # clients:
    #   RemoteBasketFile("repro://host:9147/events.bskt").read_branch("Jet_pt")
    #   TokenPipeline(["repro://host:9147/shard0.bskt", ...], ...)

``--port 0`` binds an ephemeral port; the bound address is printed as the
first stdout line (``serving ROOT on HOST:PORT``) so scripts and tests can
scrape it.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.remote",
        description="Serve a directory of BasketFiles over RBSP "
                    "(vectored coalesced reads + wire transcoding).")
    ap.add_argument("root", help="directory of .bskt containers to export")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9147,
                    help="TCP port (0 = ephemeral; printed on stdout)")
    ap.add_argument("--workers", type=int, default=4,
                    help="shared CompressionEngine width for transcoding")
    ap.add_argument("--transcode", dest="transcode", action="store_true",
                    default=True, help="allow wire transcoding (default)")
    ap.add_argument("--no-transcode", dest="transcode", action="store_false",
                    help="always ship archive payloads verbatim")
    ap.add_argument("--max-gap", type=int, default=64 << 10,
                    help="coalesce reads across holes up to this many bytes")
    ap.add_argument("--max-span", type=int, default=8 << 20,
                    help="cap one coalesced pread at this many bytes")
    ap.add_argument("--max-inflight", type=int, default=32,
                    help="concurrent request executions before queueing")
    ap.add_argument("--queue-depth", type=int, default=128,
                    help="admission queue depth before shedding RESP_BUSY")
    ap.add_argument("--idle-timeout", type=float, default=600.0,
                    help="close connections idle this many seconds")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    from repro_torch.remote import BasketServer
    server = BasketServer(args.root, host=args.host, port=args.port,
                          workers=args.workers, transcode=args.transcode,
                          max_gap=args.max_gap, max_span=args.max_span,
                          max_inflight=args.max_inflight,
                          admit_queue=args.queue_depth,
                          idle_timeout=args.idle_timeout)
    print(f"serving {server.root} on {server.host}:{server.port}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
