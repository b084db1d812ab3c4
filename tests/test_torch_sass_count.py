"""The tools that read the card's builds and compare two checkouts, on
text and numbers made here: ``apex_tpu_torch.tools.sass_count`` (the SASS
parser, its loops and its classes of instructions by pipe) and
``apex_tpu_torch.tools.tree_compare``'s comparison of two saves. Neither
needs a card for this: on the card they read real builds (``sass_count``
gives the instructions an element that ``chip_smoke.py`` holds for the
integer kernels' bounds)."""

import json

import pytest

from apex_tpu_torch.tools import sass_count, tree_compare

# two kernels as `cuobjdump -sass` prints them: a loop from 0x0030 to
# 0x0090, predicates, modifiers, a uniform instruction and NOPs
SASS = """
	code for sm_90a
		Function : _Z6kernelPfi
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;           /* 0x0 */
        /*0010*/                   ULDC.64 UR4, c[0x0][0x208] ;     /* 0x0 */
        /*0020*/                   S2R R0, SR_TID.X ;               /* 0x0 */
        /*0030*/                   LDG.E.128 R4, desc[UR4][R2.64] ; /* 0x0 */
        /*0040*/                   IMAD.WIDE.U32 R2, R0, 0x4, R2 ;  /* 0x0 */
        /*0050*/                   SHF.L.W.U32.HI R5, R5, 0xd, R5 ; /* 0x0 */
        /*0060*/                   LOP3.LUT R6, R5, R4, RZ, 0x3c, !PT ;
        /*0070*/                   FFMA R7, R6, R6, R7 ;            /* 0x0 */
        /*0080*/               @!P0 IADD3 R0, R0, 0x100, RZ ;      /* 0x0 */
        /*0090*/               @P1 BRA 0x30 ;                      /* 0x0 */
        /*00a0*/                   STG.E desc[UR4][R2.64], R7 ;     /* 0x0 */
        /*00b0*/                   EXIT ;                           /* 0x0 */
        /*00c0*/                   BRA 0xc0;                        /* 0x0 */
        /*00d0*/                   NOP;                             /* 0x0 */
		Function : _Z5otherv
        /*0000*/                   EXIT ;                           /* 0x0 */
"""


def test_functions_split_by_kernel_and_read_opcodes():
    fns = sass_count.functions(SASS)
    assert list(fns) == ["_Z6kernelPfi", "_Z5otherv"]
    body = fns["_Z6kernelPfi"]
    assert [op for _, op, _, _ in body][:5] == ["LDC", "ULDC", "S2R", "LDG",
                                                 "IMAD"]
    assert body[4][2] == ".WIDE.U32"
    assert body[8][1] == "IADD3"          # behind its predicate
    assert body[9][3] == "0x30"


def test_loops_are_branches_back():
    body = sass_count.functions(SASS)["_Z6kernelPfi"]
    # the loop back to 0x30, and the trailing self-branch
    assert sass_count.loops(body) == [(0x30, 0x90), (0xc0, 0xc0)]


def test_count_of_a_loop_by_class():
    body = sass_count.functions(SASS)["_Z6kernelPfi"]
    got = sass_count.count(body, 0x30, 0x90)
    assert got["instructions"] == 7
    # IMAD.WIDE is a multiply, the IADD3 an add either pipe runs
    assert got["classes"] == {"alu": 2, "add": 1, "imad": 1, "fp32": 1,
                              "uniform": 0, "other": 2}
    assert got["opcodes"]["LDG"] == 1
    # the whole function leaves out NOPs
    assert sass_count.count(body)["instructions"] == 13


@pytest.mark.parametrize("op,mods,cls", [
    ("IADD3", "", "add"), ("IADD3", ".X", "add"), ("LEA", ".HI", "add"),
    ("MOV", "", "add"), ("IMAD", ".IADD", "add"), ("IMAD", ".MOV.U32", "add"),
    ("IMAD", ".SHL.U32", "add"), ("LOP3", ".LUT", "alu"),
    ("SHF", ".L.W.U32.HI", "alu"), ("ISETP", ".GE.AND", "alu"),
    ("SEL", "", "alu"), ("PRMT", "", "alu"), ("IMAD", "", "imad"),
    ("IMAD", ".WIDE.U32", "imad"), ("IMAD", ".X", "imad"),
    ("FFMA", "", "fp32"), ("FADD", "", "fp32"), ("FMUL", "", "fp32"),
    ("ULDC", ".64", "uniform"), ("LDG", ".E.128", "other"),
    ("BRA", "", "other")])
def test_class_of(op, mods, cls):
    assert sass_count.class_of(op, mods) == cls


def test_per_element_divides_each_class():
    loop = {"instructions": 400, "classes": {"alu": 256, "add": 64,
                                             "imad": 8, "fp32": 56,
                                             "uniform": 0, "other": 16}}
    pe = sass_count.per_element(loop, 4)
    assert pe["instructions"] == 100
    assert pe["classes"] == {"alu": 64, "add": 16, "imad": 2, "fp32": 14,
                             "uniform": 0, "other": 4}


def test_tree_compare_reports_dx_bits_and_dw_db_differences(tmp_path,
                                                            capsys):
    first = {"layer_norm_bwd rows=5": {
                 "sha256": "a", "dw": [1.0, -4.0], "db": [2.0, 2.0],
                 "ms": 0.05, "cold_ms": 0.06, "lib_ms": 0.07},
             "layer_norm rows=5": {"sha256": "b", "ms": 0.01,
                                   "cold_ms": None, "lib_ms": None}}
    second = {"layer_norm_bwd rows=5": {
                  "sha256": "a", "dw": [1.0, -4.5], "db": [2.0, 2.0],
                  "ms": 0.02, "cold_ms": 0.03, "lib_ms": 0.07},
              "layer_norm rows=5": {"sha256": "c", "ms": 0.01,
                                    "cold_ms": None, "lib_ms": None}}
    paths = []
    for name, cases in (("a.json", first), ("b.json", second)):
        p = tmp_path / name
        p.write_text(json.dumps({"card": "x", "cases": cases}))
        paths.append(str(p))
    assert tree_compare.compare(*paths) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("layer_norm_bwd rows=5: dx bitwise True; "
                             "dw rel 1.250e-01, db rel 0.000e+00")
    assert "cold_ms 0.06000 (first) 0.03000 (second)" in out[0]
    assert out[1].startswith("layer_norm rows=5: bitwise False")
    assert tree_compare._rel([1.0, 2.0], [1.0, 4.0]) == 0.5


def test_tree_compare_reports_segment_and_leaf_sum_cases(tmp_path, capsys):
    seg = {"sha256": "mv", "p_sha256": "p1", "gg_sha256": "g1",
           "mv_plain_bitwise": True, "p_plain_bitwise": False,
           "p_within_tol": True, "gg_plain_rel": 1e-7, "ms": 0.02,
           "host_ms": 0.05}
    leaf = {"sha256": "s", "plain_bitwise": True, "repeat_bitwise": True,
            "ms": 0.0036, "lib_ms": 0.09}
    paths = []
    for name, p_hash, ms in (("a.json", "p1", 0.02), ("b.json", "p2",
                                                      0.008)):
        cases = {"lamb_segment gpt2_345m fp32": dict(seg, p_sha256=p_hash,
                                                     ms=ms),
                 "leaf_sum gpt2_345m 292 leaves": leaf}
        p = tmp_path / name
        p.write_text(json.dumps({"card": "x", "cases": cases}))
        paths.append(str(p))
    assert tree_compare.compare(*paths) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("lamb_segment gpt2_345m fp32: m'/v' bitwise "
                             "True; p bitwise False; gg bitwise True")
    assert "p_plain_bitwise False / False" in out[0]
    assert "ms 0.02000 (first) 0.00800 (second)" in out[0]
    assert "host_ms 0.05000 (first) 0.05000 (second)" in out[0]
    assert out[1].startswith("leaf_sum gpt2_345m 292 leaves: bitwise True")
    assert "repeat_bitwise True / True" in out[1]
    assert "lib_ms 0.09000" in out[1]


@pytest.mark.parametrize("text,want", [
    ("lamb_segment,leaf_sum", ("lamb_segment", "leaf_sum")),
    ("layer_norm", ("layer_norm",)), ("flash,", ("flash",))])
def test_tree_compare_only_takes_a_list_of_groups(text, want):
    assert tree_compare._groups(text) == want


@pytest.mark.parametrize("text", ["", "segment", "flash,lamb"])
def test_tree_compare_only_refuses_unknown_groups(text):
    with pytest.raises(Exception, match="comma-separated"):
        tree_compare._groups(text)
