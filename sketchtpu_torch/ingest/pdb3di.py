"""PDB -> 3Di conversion (optional, like the reference's `3di` feature).

Mirrors the reference's embedded Python helper
(sketchlib.rust python_mini3di/3di_convert.py, called from
src/structures.rs:14-57): each chain of the structure is encoded with
mini3di and chains are comma-joined; the ',' is not a valid amino-acid
byte, so it acts as a window break during hashing, exactly the
from_3di_string semantics (aahash_iterator.rs:132-136).

Requires the external `mini3di` and `biopython` packages, which the
reference also only ships behind its optional `3di` cargo feature; without
them the CLI flag raises the same kind of error the reference build emits
when compiled without the feature.
"""

from __future__ import annotations


def pdb_to_3di(struct_name: str, filename: str) -> str:
    try:
        import mini3di
        from Bio.PDB import PDBParser
    except ImportError as exc:
        raise RuntimeError(
            "--convert-pdb requires the optional 'mini3di' and 'biopython' "
            "packages (the reference gates this behind its '3di' feature)"
        ) from exc
    from warnings import warn

    encoder = mini3di.Encoder()
    parser = PDBParser(QUIET=True)
    struct = parser.get_structure(struct_name, filename)
    parts = []
    for chain in struct.get_chains():
        try:
            states = encoder.encode_chain(chain)
            parts.append(encoder.build_sequence(states))
        except IndexError:
            warn(
                f"Not able to code into 3Di chain {chain!r} from protein ID "
                f"{struct_name}",
                RuntimeWarning,
            )
            continue
    return ",".join(parts)
