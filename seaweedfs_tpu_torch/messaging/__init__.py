"""Pub/sub messaging on filer infrastructure (`weed msg.broker`).

Reference: weed/messaging/broker/ — brokers expose publish/subscribe
streams; each topic is partitioned, every partition is an append-only
log living *in the filer* (in-memory LogBuffer tail + flushed segment
files under /topics/<namespace>/<topic>/<partition>/), and topic
partitions map to brokers by consistent hashing
(consistent_distribution.go).
"""

from .broker import MessageBroker  # noqa: F401
from .client import MessagingClient  # noqa: F401
from .consistent_hash import HashRing  # noqa: F401
from .topic_log import TopicPartitionLog  # noqa: F401
