"""Jellyfish-style file headers (counterpart of quorum_tpu/io/ref_db.py):
the JSON document at the head of a reference `binary/quorum_db`
database and of a Jellyfish `binary_dumper` file.

The document is arbitrary formatted JSON followed immediately by binary
payload, so its end is found by brace matching (tracking strings and
escapes), not by line structure.
"""

from __future__ import annotations

import json

REF_FORMAT = "binary/quorum_db"


class RefHeaderError(ValueError):
    """File does not carry a parseable Jellyfish-style JSON header."""


def parse_jf_header(data: bytes) -> tuple[dict, int]:
    """Parse the JSON header at the start of `data`. Returns
    (header_dict, end_offset), end_offset one past the closing brace."""
    i = 0
    while i < len(data) and data[i:i + 1].isspace():
        i += 1
    if i >= len(data) or data[i] != ord("{"):
        raise RefHeaderError("no JSON object at start of file")
    depth = 0
    in_str = False
    esc = False
    for j in range(i, len(data)):
        c = data[j]
        if in_str:
            if esc:
                esc = False
            elif c == ord("\\"):
                esc = True
            elif c == ord('"'):
                in_str = False
        elif c == ord('"'):
            in_str = True
        elif c == ord("{"):
            depth += 1
        elif c == ord("}"):
            depth -= 1
            if depth == 0:
                try:
                    return json.loads(data[i:j + 1]), j + 1
                except json.JSONDecodeError as e:
                    raise RefHeaderError(f"malformed JSON header: {e}") from e
    raise RefHeaderError("unterminated JSON header")


def read_ref_header(path: str, max_header: int = 1 << 20
                    ) -> tuple[dict, int]:
    """Read and parse the header of a reference-format file. Returns
    (header, payload_offset): the position after the JSON document,
    aligned to the header's `alignment` field (8 when absent)."""
    with open(path, "rb") as f:
        data = f.read(max_header)
    header, end = parse_jf_header(data)
    align = int(header.get("alignment", 8) or 8)
    return header, -(-end // align) * align
