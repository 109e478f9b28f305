"""Cluster roles of the port: so far the master over the HTTP/JSON
control plane (`rpc`), with its resilience policy and repair daemon."""
