"""S3-compatible gateway over the filer.

Reference: weed/s3api/ — s3api_server.go (route table), auth_signature_v4.go
(AWS sig v4 verification), auth_credentials.go (identities + actions),
filer_multipart.go (multipart assembled by merging chunk lists),
s3api_object_handlers / bucket_handlers (XML protocol).
"""

from .auth import Identity, IdentityAccessManagement  # noqa: F401
from .server import S3ApiServer  # noqa: F401
