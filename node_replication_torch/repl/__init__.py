"""repl/: WAL-shipping follower fleets — read scale-out, bounded
staleness, measured-RTO promotion.

The port of `node_replication_tpu/repl/`. Feed message files, wire
frames, WAL records and snapshots are the reference's bytes, so a
follower of either package tails a feed shipped by the other. A
follower's fleet is the port's `NodeReplicated`: on a hashmap fleet
with `engine="pallas"` every record it applies is one fused combiner
round (K1, `csrc/hashmap_replay.cu`) on the card.

The replication plane, and the first multi-process subsystem: the
segmented write-ahead log (`durable/wal.py`) is already a complete,
CRC-framed, position-chained replication stream,
so a **shipper** streams it (closed segments + a tailing feed of the
active one) into a transport-abstracted **feed**; **followers** in
other processes replay it through the same deterministic combiner
protocol — bit-identical state at every common position — and serve
reads at a bounded-staleness cursor through a read-only
`ServeFrontend`. Ship-before-ack (`shipper.barrier` as the frontend's
`ack_barrier`) makes acks survive primary loss; on primary death the
**promotion** path (heartbeat watch on `fault/`'s health machine)
elects the most-advanced follower, drains the feed under the
torn-tail rules, fences the dead primary's epoch so zombie records
are rejected, and re-homes durable-ack write serving — classic
log-shipping primary/replica architecture built from parts the repo
already proves.

    feed = DirectoryFeed(shared_dir)
    shipper = ReplicationShipper(primary.wal, feed)   # on the primary
    frontend.ack_barrier = shipper.barrier            # ship-before-ack

    f = Follower(dispatch, feed, directory=my_dir)    # other process
    v = f.read((HM_GET, k), max_lag_pos=64)           # bounded staleness

    mgr = PromotionManager(feed, [f])
    mgr.start()                                       # heartbeat watch
    report = mgr.wait()                               # measured RTO

Cross-host: `transport.py` carries the same stream over
TCP — `FeedServer` serves any feed-shaped source (plus snapshots for
cold-follower bootstrap), `SocketFeed` is the far end's drop-in feed —
and `relay.py`'s `RelayNode` is a feed-of-feeds interior node, so a
1→R→N tree ships each record once per edge instead of N× from the
primary:

    srv = FeedServer(feed, snapshot_dir=primary_dir)  # on the primary
    up = SocketFeed(*srv.address, arg_width=aw)       # another host
    relay = RelayNode(up, directory=relay_dir, arg_width=aw)
    leaf = SocketFeed(*relay.address, arg_width=aw)
    f = Follower(dispatch, leaf, directory=my_dir)    # bootstraps from
    ...                                               # the snapshot
"""

from node_replication_torch.repl.feed import (
    DirectoryFeed,
    EpochFencedError,
    FeedCorruptError,
    FeedError,
    FeedGapError,
    FeedRecord,
)
from node_replication_torch.repl.follower import Follower
from node_replication_torch.repl.promote import (
    PromotionManager,
    PromotionReport,
)
from node_replication_torch.repl.relay import RelayNode
from node_replication_torch.repl.shipper import (
    SHIP_PIN,
    ReplicationShipper,
    ShipError,
)
from node_replication_torch.repl.transport import (
    FeedServer,
    PipeTransport,
    SocketFeed,
    TransportError,
    make_tree_barrier,
)

__all__ = [
    "DirectoryFeed",
    "EpochFencedError",
    "FeedCorruptError",
    "FeedError",
    "FeedGapError",
    "FeedRecord",
    "FeedServer",
    "Follower",
    "PipeTransport",
    "PromotionManager",
    "PromotionReport",
    "RelayNode",
    "ReplicationShipper",
    "SHIP_PIN",
    "ShipError",
    "SocketFeed",
    "TransportError",
    "make_tree_barrier",
]
