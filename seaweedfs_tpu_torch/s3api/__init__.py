"""S3 pieces the storage tier needs: the AWS sig v4 request signer."""
