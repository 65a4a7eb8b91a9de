"""Reference interoperability: byte-level codecs for the Go reference's
serialized artifacts (sachaservan/bgn).  The port's counterpart of
`bgn_tpu/interop`, with the same bytes.

Three layers:
  - gob.py       -- a subset codec for Go's encoding/gob wire format (the
                    reference marshals everything with gob, bgn.go:595-666,
                    ciphertext.go:76-116)
  - pbc.py       -- PBC type-A1 params-string and Element.Bytes codecs
                    (the layouts pbc's element_to_bytes / param_out_str
                    produce, consumed at bgn.go:501-560, 583-593)
  - reference.py -- wrapper-struct import/export gluing both to the
                    port's key / ciphertext types, plus the
                    conformance-vector loader for tools/dump_reference.go
                    output

See docs/INTEROP.md for the byte-level format specification.
"""

from .conformance import (  # noqa: F401
    ConformanceError,
    synthesize_vectors,
    verify_reference_vectors,
)
from .reference import (  # noqa: F401
    ciphertext_from_gob,
    ciphertext_to_gob,
    import_reference_key,
    load_reference_vectors,
    poly_ciphertext_from_gob,
    poly_ciphertext_to_gob,
    public_key_from_gob,
    public_key_to_gob,
)
