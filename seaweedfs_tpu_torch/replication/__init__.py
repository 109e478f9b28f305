"""Cross-cluster replication: only the `.rlog` change log that a
volume's commit path writes into (rlog.py) is here; the shipper, the
lease plane and the rest of the mirror are not ported yet."""
