"""Cluster plane of the port: so far only `rpc.RpcError`."""
