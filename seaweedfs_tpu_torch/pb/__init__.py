"""Wire-compatible gRPC control plane (reference: weed/pb/).

`master.proto` mirrors the reference's `Seaweed` service shapes so
`weed`-style gRPC clients port over; `master_grpc.MasterGrpcServer`
serves it as a facade over the same master internals the JSON/HTTP
plane uses.  Generated code (`master_pb2.py`) is checked in; regenerate
with `protoc --python_out=. master.proto` in this directory.
"""
