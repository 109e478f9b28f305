"""Cluster metadata & scheduling: the master's topology tree, volume
layouts, placement, and sequencers (reference: weed/topology/)."""
