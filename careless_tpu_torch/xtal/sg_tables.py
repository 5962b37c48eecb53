"""Space-group tables: number / Hermann-Mauguin symbol -> Hall symbol.

The port's own copy of careless_tpu/xtal/sg_tables.py. Standard settings:
monoclinic unique axis b (cell choice 1), rhombohedral groups on hexagonal
axes, origin choice 2 (inversion at origin) for the two-origin groups.

Note on correctness surface: for merging work only *intensity-domain*
properties matter (Laue group, centric flags, epsilon factors, systematic
absences). These are invariant to origin choice, so the Hall origin-shift
entries only affect phases we never compute. tests/test_torch_xtal.py
holds the groups built from this table equal to the JAX package's.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# (number, short H-M, Hall) — standard settings.
SG_TABLE: List[Tuple[int, str, str]] = [
    (1, "P 1", "P 1"),
    (2, "P -1", "-P 1"),
    (3, "P 2", "P 2y"),
    (4, "P 21", "P 2yb"),
    (5, "C 2", "C 2y"),
    (6, "P m", "P -2y"),
    (7, "P c", "P -2yc"),
    (8, "C m", "C -2y"),
    (9, "C c", "C -2yc"),
    (10, "P 2/m", "-P 2y"),
    (11, "P 21/m", "-P 2yb"),
    (12, "C 2/m", "-C 2y"),
    (13, "P 2/c", "-P 2yc"),
    (14, "P 21/c", "-P 2ybc"),
    (15, "C 2/c", "-C 2yc"),
    (16, "P 2 2 2", "P 2 2"),
    (17, "P 2 2 21", "P 2c 2"),
    (18, "P 21 21 2", "P 2 2ab"),
    (19, "P 21 21 21", "P 2ac 2ab"),
    (20, "C 2 2 21", "C 2c 2"),
    (21, "C 2 2 2", "C 2 2"),
    (22, "F 2 2 2", "F 2 2"),
    (23, "I 2 2 2", "I 2 2"),
    (24, "I 21 21 21", "I 2b 2c"),
    (25, "P m m 2", "P 2 -2"),
    (26, "P m c 21", "P 2c -2"),
    (27, "P c c 2", "P 2 -2c"),
    (28, "P m a 2", "P 2 -2a"),
    (29, "P c a 21", "P 2c -2ac"),
    (30, "P n c 2", "P 2 -2bc"),
    (31, "P m n 21", "P 2ac -2"),
    (32, "P b a 2", "P 2 -2ab"),
    (33, "P n a 21", "P 2c -2n"),
    (34, "P n n 2", "P 2 -2n"),
    (35, "C m m 2", "C 2 -2"),
    (36, "C m c 21", "C 2c -2"),
    (37, "C c c 2", "C 2 -2c"),
    (38, "A m m 2", "A 2 -2"),
    (39, "A b m 2", "A 2 -2b"),
    (40, "A m a 2", "A 2 -2a"),
    (41, "A b a 2", "A 2 -2ab"),
    (42, "F m m 2", "F 2 -2"),
    (43, "F d d 2", "F 2 -2d"),
    (44, "I m m 2", "I 2 -2"),
    (45, "I b a 2", "I 2 -2c"),
    (46, "I m a 2", "I 2 -2a"),
    (47, "P m m m", "-P 2 2"),
    (48, "P n n n", "-P 2ab 2bc"),
    (49, "P c c m", "-P 2 2c"),
    (50, "P b a n", "-P 2ab 2b"),
    (51, "P m m a", "-P 2a 2a"),
    (52, "P n n a", "-P 2a 2bc"),
    (53, "P m n a", "-P 2ac 2"),
    (54, "P c c a", "-P 2a 2ac"),
    (55, "P b a m", "-P 2 2ab"),
    (56, "P c c n", "-P 2ab 2ac"),
    (57, "P b c m", "-P 2c 2b"),
    (58, "P n n m", "-P 2 2n"),
    (59, "P m m n", "-P 2ab 2a"),
    (60, "P b c n", "-P 2n 2ab"),
    (61, "P b c a", "-P 2ac 2ab"),
    (62, "P n m a", "-P 2ac 2n"),
    (63, "C m c m", "-C 2c 2"),
    (64, "C m c a", "-C 2bc 2"),
    (65, "C m m m", "-C 2 2"),
    (66, "C c c m", "-C 2 2c"),
    (67, "C m m a", "-C 2b 2"),
    (68, "C c c a", "-C 2b 2bc"),
    (69, "F m m m", "-F 2 2"),
    (70, "F d d d", "-F 2uv 2vw"),
    (71, "I m m m", "-I 2 2"),
    (72, "I b a m", "-I 2 2c"),
    (73, "I b c a", "-I 2b 2c"),
    (74, "I m m a", "-I 2b 2"),
    (75, "P 4", "P 4"),
    (76, "P 41", "P 4w"),
    (77, "P 42", "P 4c"),
    (78, "P 43", "P 4cw"),
    (79, "I 4", "I 4"),
    (80, "I 41", "I 4bw"),
    (81, "P -4", "P -4"),
    (82, "I -4", "I -4"),
    (83, "P 4/m", "-P 4"),
    (84, "P 42/m", "-P 4c"),
    (85, "P 4/n", "-P 4a"),
    (86, "P 42/n", "-P 4bc"),
    (87, "I 4/m", "-I 4"),
    (88, "I 41/a", "-I 4ad"),
    (89, "P 4 2 2", "P 4 2"),
    (90, "P 4 21 2", "P 4ab 2ab"),
    (91, "P 41 2 2", "P 4w 2c"),
    (92, "P 41 21 2", "P 4abw 2nw"),
    (93, "P 42 2 2", "P 4c 2"),
    (94, "P 42 21 2", "P 4n 2n"),
    (95, "P 43 2 2", "P 4cw 2c"),
    (96, "P 43 21 2", "P 4nw 2abw"),
    (97, "I 4 2 2", "I 4 2"),
    (98, "I 41 2 2", "I 4bw 2bw"),
    (99, "P 4 m m", "P 4 -2"),
    (100, "P 4 b m", "P 4 -2ab"),
    (101, "P 42 c m", "P 4c -2c"),
    (102, "P 42 n m", "P 4n -2n"),
    (103, "P 4 c c", "P 4 -2c"),
    (104, "P 4 n c", "P 4 -2n"),
    (105, "P 42 m c", "P 4c -2"),
    (106, "P 42 b c", "P 4c -2ab"),
    (107, "I 4 m m", "I 4 -2"),
    (108, "I 4 c m", "I 4 -2c"),
    (109, "I 41 m d", "I 4bw -2"),
    (110, "I 41 c d", "I 4bw -2c"),
    (111, "P -4 2 m", "P -4 2"),
    (112, "P -4 2 c", "P -4 2c"),
    (113, "P -4 21 m", "P -4 2ab"),
    (114, "P -4 21 c", "P -4 2n"),
    (115, "P -4 m 2", "P -4 -2"),
    (116, "P -4 c 2", "P -4 -2c"),
    (117, "P -4 b 2", "P -4 -2ab"),
    (118, "P -4 n 2", "P -4 -2n"),
    (119, "I -4 m 2", "I -4 -2"),
    (120, "I -4 c 2", "I -4 -2c"),
    (121, "I -4 2 m", "I -4 2"),
    (122, "I -4 2 d", "I -4 2bw"),
    (123, "P 4/m m m", "-P 4 2"),
    (124, "P 4/m c c", "-P 4 2c"),
    (125, "P 4/n b m", "-P 4a 2b"),
    (126, "P 4/n n c", "-P 4a 2bc"),
    (127, "P 4/m b m", "-P 4 2ab"),
    (128, "P 4/m n c", "-P 4 2n"),
    (129, "P 4/n m m", "-P 4a 2a"),
    (130, "P 4/n c c", "-P 4a 2ac"),
    (131, "P 42/m m c", "-P 4c 2"),
    (132, "P 42/m c m", "-P 4c 2c"),
    (133, "P 42/n b c", "-P 4ac 2b"),
    (134, "P 42/n n m", "-P 4ac 2bc"),
    (135, "P 42/m b c", "-P 4c 2ab"),
    (136, "P 42/m n m", "-P 4n 2n"),
    (137, "P 42/n m c", "-P 4ac 2a"),
    (138, "P 42/n c m", "-P 4ac 2ac"),
    (139, "I 4/m m m", "-I 4 2"),
    (140, "I 4/m c m", "-I 4 2c"),
    (141, "I 41/a m d", "-I 4bd 2"),
    (142, "I 41/a c d", "-I 4bd 2c"),
    (143, "P 3", "P 3"),
    (144, "P 31", "P 31"),
    (145, "P 32", "P 32"),
    (146, "R 3", "R 3"),
    (147, "P -3", "-P 3"),
    (148, "R -3", "-R 3"),
    (149, "P 3 1 2", "P 3 2"),
    (150, "P 3 2 1", 'P 3 2"'),
    (151, "P 31 1 2", "P 31 2 (0 0 4)"),
    (152, "P 31 2 1", 'P 31 2"'),
    (153, "P 32 1 2", "P 32 2 (0 0 2)"),
    (154, "P 32 2 1", 'P 32 2"'),
    (155, "R 3 2", 'R 3 2"'),
    (156, "P 3 m 1", 'P 3 -2"'),
    (157, "P 3 1 m", "P 3 -2"),
    (158, "P 3 c 1", 'P 3 -2"c'),
    (159, "P 3 1 c", "P 3 -2c"),
    (160, "R 3 m", 'R 3 -2"'),
    (161, "R 3 c", 'R 3 -2"c'),
    (162, "P -3 1 m", "-P 3 2"),
    (163, "P -3 1 c", "-P 3 2c"),
    (164, "P -3 m 1", '-P 3 2"'),
    (165, "P -3 c 1", '-P 3 2"c'),
    (166, "R -3 m", '-R 3 2"'),
    (167, "R -3 c", '-R 3 2"c'),
    (168, "P 6", "P 6"),
    (169, "P 61", "P 61"),
    (170, "P 65", "P 65"),
    (171, "P 62", "P 62"),
    (172, "P 64", "P 64"),
    (173, "P 63", "P 6c"),
    (174, "P -6", "P -6"),
    (175, "P 6/m", "-P 6"),
    (176, "P 63/m", "-P 6c"),
    (177, "P 6 2 2", "P 6 2"),
    (178, "P 61 2 2", "P 61 2 (0 0 5)"),
    (179, "P 65 2 2", "P 65 2 (0 0 1)"),
    (180, "P 62 2 2", "P 62 2 (0 0 4)"),
    (181, "P 64 2 2", "P 64 2 (0 0 2)"),
    (182, "P 63 2 2", "P 6c 2c"),
    (183, "P 6 m m", "P 6 -2"),
    (184, "P 6 c c", "P 6 -2c"),
    (185, "P 63 c m", "P 6c -2"),
    (186, "P 63 m c", "P 6c -2c"),
    (187, "P -6 m 2", "P -6 2"),
    (188, "P -6 c 2", "P -6c 2"),
    (189, "P -6 2 m", "P -6 -2"),
    (190, "P -6 2 c", "P -6c -2c"),
    (191, "P 6/m m m", "-P 6 2"),
    (192, "P 6/m c c", "-P 6 2c"),
    (193, "P 63/m c m", "-P 6c 2"),
    (194, "P 63/m m c", "-P 6c 2c"),
    (195, "P 2 3", "P 2 2 3"),
    (196, "F 2 3", "F 2 2 3"),
    (197, "I 2 3", "I 2 2 3"),
    (198, "P 21 3", "P 2ac 2ab 3"),
    (199, "I 21 3", "I 2b 2c 3"),
    (200, "P m -3", "-P 2 2 3"),
    (201, "P n -3", "-P 2ab 2bc 3"),
    (202, "F m -3", "-F 2 2 3"),
    (203, "F d -3", "-F 2uv 2vw 3"),
    (204, "I m -3", "-I 2 2 3"),
    (205, "P a -3", "-P 2ac 2ab 3"),
    (206, "I a -3", "-I 2b 2c 3"),
    (207, "P 4 3 2", "P 4 2 3"),
    (208, "P 42 3 2", "P 4n 2 3"),
    (209, "F 4 3 2", "F 4 2 3"),
    (210, "F 41 3 2", "F 4d 2 3"),
    (211, "I 4 3 2", "I 4 2 3"),
    (212, "P 43 3 2", "P 4acd 2ab 3"),
    (213, "P 41 3 2", "P 4bd 2ab 3"),
    (214, "I 41 3 2", "I 4bd 2c 3"),
    (215, "P -4 3 m", "P -4 2 3"),
    (216, "F -4 3 m", "F -4 2 3"),
    (217, "I -4 3 m", "I -4 2 3"),
    (218, "P -4 3 n", "P -4n 2 3"),
    (219, "F -4 3 c", "F -4a 2 3"),
    (220, "I -4 3 d", "I -4bd 2c 3"),
    (221, "P m -3 m", "-P 4 2 3"),
    (222, "P n -3 n", "-P 4a 2bc 3"),
    (223, "P m -3 n", "-P 4n 2 3"),
    (224, "P n -3 m", "-P 4bc 2bc 3"),
    (225, "F m -3 m", "-F 4 2 3"),
    (226, "F m -3 c", "-F 4a 2 3"),
    (227, "F d -3 m", "-F 4vw 2vw 3"),
    (228, "F d -3 c", "-F 4ud 2vw 3"),
    (229, "I m -3 m", "-I 4 2 3"),
    (230, "I a -3 d", "-I 4bd 2c 3"),
]

# Alternate settings / aliases worth resolving by name.
EXTRA_SETTINGS: List[Tuple[str, str]] = [
    ("R 3 :H", "R 3"),
    ("R 3 :R", "P 3*"),
    ("R -3 :H", "-R 3"),
    ("R -3 :R", "-P 3*"),
    ("R 3 2 :H", 'R 3 2"'),
    ("R 3 2 :R", "P 3* 2"),
    ("R 3 m :H", 'R 3 -2"'),
    ("R 3 m :R", "P 3* -2"),
    ("R 3 c :H", 'R 3 -2"c'),
    ("R 3 c :R", "P 3* -2n"),
    ("R -3 m :H", '-R 3 2"'),
    ("R -3 m :R", "-P 3* 2"),
    ("R -3 c :H", '-R 3 2"c'),
    ("R -3 c :R", "-P 3* 2n"),
    ("P 1 21 1", "P 2yb"),
    ("P 1 2 1", "P 2y"),
    ("C 1 2 1", "C 2y"),
    ("P 1 m 1", "P -2y"),
    ("P 1 c 1", "P -2yc"),
    ("C 1 m 1", "C -2y"),
    ("C 1 c 1", "C -2yc"),
    ("P 1 2/m 1", "-P 2y"),
    ("P 1 21/m 1", "-P 2yb"),
    ("C 1 2/m 1", "-C 2y"),
    ("P 1 2/c 1", "-P 2yc"),
    ("P 1 21/c 1", "-P 2ybc"),
    ("P 1 21/n 1", "-P 2yn"),
    ("C 1 2/c 1", "-C 2yc"),
    ("A e m 2", "A 2 -2b"),
    ("A e a 2", "A 2 -2ab"),
    ("C m c e", "-C 2bc 2"),
    ("C m m e", "-C 2b 2"),
    ("C c c e", "-C 2b 2bc"),
    ("H 3", "R 3"),
    ("H -3", "-R 3"),
    ("H 3 2", 'R 3 2"'),
    ("H 3 m", 'R 3 -2"'),
    ("H -3 m", '-R 3 2"'),
]

_BY_NUMBER: Dict[int, Tuple[str, str]] = {n: (hm, hall) for n, hm, hall in SG_TABLE}


def _squash(name: str) -> str:
    return re.sub(r"[\s_]+", "", name).upper()


_BY_NAME: Dict[str, str] = {}
for _n, _hm, _hall in SG_TABLE:
    _BY_NAME[_squash(_hm)] = _hall
for _hm, _hall in EXTRA_SETTINGS:
    _BY_NAME.setdefault(_squash(_hm), _hall)


def lookup_hall(key) -> Tuple[str, Optional[int], Optional[str]]:
    """Resolve a space-group spec -> (hall, number_or_None, hm_or_None).

    Accepts: int or numeric string (ITA number), short H-M with or without
    spaces ("P 21 21 21", "P212121"), "Hall:<symbol>", or an explicit Hall
    symbol prefixed string.
    """
    if isinstance(key, (int,)) or (isinstance(key, str) and key.strip().isdigit()):
        num = int(key)
        if num not in _BY_NUMBER:
            raise ValueError(f"unknown space group number {num}")
        hm, hall = _BY_NUMBER[num]
        return hall, num, hm
    if not isinstance(key, str):
        raise TypeError(f"bad space group spec {key!r}")
    s = key.strip()
    if s.lower().startswith("hall:"):
        return s[5:].strip(), None, None
    squashed = _squash(s)
    if squashed in _BY_NAME:
        hall = _BY_NAME[squashed]
        # recover canonical number/hm if this is a standard setting
        for n, hm, h in SG_TABLE:
            if h == hall:
                return hall, n, hm
        return hall, None, s
    raise ValueError(f"unknown space group {key!r}")


# ------------------------------------------------------------------ validation
_POINT_GROUP_ORDER = {
    "1": 1, "-1": 2, "2": 2, "m": 2, "2/m": 4,
    "222": 4, "mm2": 4, "2mm": 4, "m2m": 4, "mmm": 8,
    "4": 4, "-4": 4, "4/m": 8, "422": 8, "4mm": 8,
    "-42m": 8, "-4m2": 8, "4/mmm": 16,
    "3": 3, "-3": 6, "32": 6, "321": 6, "312": 6,
    "3m": 6, "3m1": 6, "31m": 6, "-3m": 12, "-3m1": 12, "-31m": 12,
    "6": 6, "-6": 6, "6/m": 12, "622": 12, "6mm": 12,
    "-6m2": 12, "-62m": 12, "6/mmm": 24,
    "23": 12, "m-3": 24, "432": 24, "-43m": 24, "m-3m": 48,
}

_N_CENTERING = {"P": 1, "A": 2, "B": 2, "C": 2, "I": 2, "R": 3, "F": 4, "H": 3}


def hm_point_group(hm: str) -> str:
    """Decode an H-M symbol to its point group (translations stripped)."""
    parts = hm.split()
    comps = []
    for p in parts[1:]:
        p = re.sub(r"^(-?)([2346])[1-5]", r"\1\2", p)  # screw -> rotation
        p = re.sub(r"^(-?)([2346])[1-5](/)", r"\1\2\3", p)
        if "/" in p:
            rot, plane = p.split("/")
            rot = re.sub(r"([2346])[1-5]$", r"\1", rot)
            comps.append(rot + "/m")
        else:
            p = re.sub(r"[abcdne]", "m", p)
            comps.append(p)
    comps = [c for c in comps if c != "1"] or ["1"]
    pg = "".join(comps)
    # special-case: trigonal/hexagonal retain 1 placeholders in the order dict
    if pg not in _POINT_GROUP_ORDER:
        # retry keeping the 1s (e.g. "321")
        comps_all = []
        for p in hm.split()[1:]:
            p = re.sub(r"^(-?)([2346])[1-5]", r"\1\2", p)
            p = re.sub(r"[abcdne]", "m", p)
            comps_all.append(p)
        pg = "".join(comps_all)
    return pg


def expected_group_order(hm: str) -> int:
    pg = hm_point_group(hm)
    lat = hm.split()[0].lstrip("-").upper()
    return _POINT_GROUP_ORDER[pg] * _N_CENTERING[lat]
