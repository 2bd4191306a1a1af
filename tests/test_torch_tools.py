"""Port parity of the tooling path: the KV row insert (kernel K7) and the
stream kernel (K8) against the reference scripts' Pallas kernels, rebuilt
here as the scripts launch them and run in interpret mode; the port's
timing helpers; the tools' `--smoke` runs end to end on the CPU; and the
flash bench's floors, SASS loop count and `--against` sources.
"""

import json
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rag_inference_pipeline_tpu_torch import bench
from rag_inference_pipeline_tpu_torch.models.layers import QuantizedLinear
from rag_inference_pipeline_tpu_torch.ops import kv as tkv
from rag_inference_pipeline_tpu_torch.ops import stream as tstream
from rag_inference_pipeline_tpu_torch.ops import w8a8
from rag_inference_pipeline_tpu_torch.tools import bench_decode_anatomy as anatomy
from rag_inference_pipeline_tpu_torch.tools import bench_flash
from rag_inference_pipeline_tpu_torch.tools import bench_kernel as lab
from rag_inference_pipeline_tpu_torch.tools import bench_w8a8


# --- the reference kernels, as scripts/bench_decode_anatomy.py:88-117 and
# scripts/bench_kernel.py:171-197 build and launch them --------------------


def _row_insert_kernel(pos_ref, new_ref, cache_ref, out_ref):
    del pos_ref, cache_ref
    out_ref[...] = new_ref[...]


def _pallas_row_insert(cache, new, positions):
    bsz, s_len, h_, d_ = cache.shape
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(bsz,),
        in_specs=[
            pl.BlockSpec((1, 1, h_, d_), lambda b, pos: (b, 0, 0, 0)),
            pl.BlockSpec((1, 1, h_, d_), lambda b, pos: (b, pos[b], 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, h_, d_), lambda b, pos: (b, pos[b], 0, 0)),
    )
    return pl.pallas_call(
        _row_insert_kernel,
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct(cache.shape, cache.dtype),
        input_output_aliases={2: 0},
        interpret=True,
    )(positions, new[:, None], cache)


def stream_kernel(q_ref, db_ref, out_ref):
    i = pl.program_id(0)

    @pl.when(i == 0)
    def _():
        out_ref[:] = q_ref[:]

    out_ref[:] = out_ref[:] + db_ref[0:8, 0:128].astype(jnp.int32)


def _pallas_stream(q, db_i8, chunk):
    n, d = db_i8.shape
    return pl.pallas_call(
        stream_kernel,
        grid=(n // chunk,),
        in_specs=[
            pl.BlockSpec((8, 128), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((chunk, d), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("arbitrary",)),
        interpret=True,
    )(q, db_i8)


class TestK7:
    @pytest.mark.parametrize("dtype,pos", [
        ("bfloat16", [3, 0, 15]),
        ("float32", [20, 7, 15]),  # 20 >= S = 16: the last row is written
        ("bfloat16", [16, 16, 2]),
    ])
    def test_plain_matches_pallas(self, dtype, pos):
        rng = np.random.default_rng(len(dtype) + pos[0])
        b, s, h, d = 3, 16, 2, 64
        cache = rng.standard_normal((b, s, h, d)).astype(np.float32)
        new = rng.standard_normal((b, h, d)).astype(np.float32)
        positions = np.array(pos, np.int32)
        ref = _pallas_row_insert(
            jnp.asarray(cache, getattr(jnp, dtype)),
            jnp.asarray(new, getattr(jnp, dtype)), jnp.asarray(positions),
        )
        t_cache = torch.from_numpy(cache).to(getattr(torch, dtype))
        before = tkv.kv_row_insert.launches
        out = tkv.kv_row_insert(
            t_cache, torch.from_numpy(new).to(getattr(torch, dtype)),
            torch.from_numpy(positions),
        )
        assert out is t_cache  # in place
        assert tkv.kv_row_insert.launches == before  # the CPU runs the plain version
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))

    def test_refuses_mismatched_shapes(self):
        cache = torch.zeros((2, 8, 2, 16))
        with pytest.raises(ValueError, match="disagree"):
            tkv.kv_row_insert(cache, torch.zeros((2, 2, 8)), torch.zeros(2, dtype=torch.int32))
        with pytest.raises(ValueError, match="CUDA"):
            tkv.kv_row_insert(cache, torch.zeros((2, 2, 16)),
                              torch.zeros(2, dtype=torch.int32, device="meta"))

    @pytest.mark.parametrize("dtype,pos", [
        ("bfloat16", [3, 0, 15, 7]),
        ("float32", [20, -3, 15, 2]),  # past the end: row S-1; -3: row S-3
        ("bfloat16", [16, -1, -16, -40]),  # -16: row 0; -40 clamps to row 0
    ])
    def test_pair_plain_matches_two_pallas_inserts(self, dtype, pos):
        """The pair writes what the reference's kernel writes when it is
        launched once for K and once for V."""
        rng = np.random.default_rng(len(dtype) + pos[0] + 7)
        b, s, h, d = 4, 16, 2, 64
        cache_k, cache_v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                            for _ in range(2))
        new_k, new_v = (rng.standard_normal((b, h, d)).astype(np.float32)
                        for _ in range(2))
        positions = np.array(pos, np.int32)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        refs = [_pallas_row_insert(jnp.asarray(c, jdt), jnp.asarray(n, jdt),
                                   jnp.asarray(positions))
                for c, n in ((cache_k, new_k), (cache_v, new_v))]
        t_k, t_v = (torch.from_numpy(c).to(tdt) for c in (cache_k, cache_v))
        out_k, out_v = tkv.kv_row_insert_pair_plain(
            t_k, t_v, torch.from_numpy(new_k).to(tdt), torch.from_numpy(new_v).to(tdt),
            torch.from_numpy(positions),
        )
        assert out_k is t_k and out_v is t_v  # in place
        for out, ref in ((out_k, refs[0]), (out_v, refs[1])):
            np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))

    @pytest.mark.parametrize("pair", [False, True])
    def test_cpu_wrappers_launch_nothing(self, pair):
        rng = np.random.default_rng(11)
        cache = torch.from_numpy(rng.standard_normal((3, 8, 2, 16)).astype(np.float32))
        new = torch.from_numpy(rng.standard_normal((3, 2, 16)).astype(np.float32))
        pos = torch.tensor([1, 9, -2], dtype=torch.int32)
        ref = tkv.kv_row_insert_plain(cache.clone(), new, pos)
        fn = tkv.kv_row_insert_pair if pair else tkv.kv_row_insert
        before = fn.launches
        if pair:
            out_k, out_v = fn(cache.clone(), cache.clone(), new, new, pos)
            assert torch.equal(out_k, ref) and torch.equal(out_v, ref)
        else:
            assert torch.equal(fn(cache.clone(), new, pos), ref)
        assert fn.launches == before

    @pytest.mark.parametrize("fault,error,match", [
        ("dtype", TypeError, "dtype"),
        ("v_dtype", TypeError, "dtype"),
        ("shape", ValueError, "disagree"),
        ("v_shape", ValueError, "disagree"),
        ("positions", ValueError, "disagree"),
        ("device", ValueError, "CUDA"),
        ("v_device", ValueError, "CUDA"),
    ])
    def test_wrappers_refuse_mismatches(self, fault, error, match):
        """Both wrappers check before they dispatch: a CPU call with a
        mismatched dtype, shape or device raises, as a CUDA call does."""
        ck, cv = torch.zeros((2, 8, 2, 16)), torch.zeros((2, 8, 2, 16))
        nk, nv = torch.zeros((2, 2, 16)), torch.zeros((2, 2, 16))
        pos = torch.zeros(2, dtype=torch.int32)
        if fault == "dtype":
            nk = nk.double()
        elif fault == "v_dtype":
            cv = cv.half()
        elif fault == "shape":
            nk = torch.zeros((2, 2, 8))
        elif fault == "v_shape":
            cv = torch.zeros((2, 9, 2, 16))
        elif fault == "positions":
            pos = torch.zeros(3, dtype=torch.int32)
        elif fault == "device":
            pos = pos.to("meta")
        else:
            nv = nv.to("meta")
        before = (tkv.kv_row_insert.launches, tkv.kv_row_insert_pair.launches)
        with pytest.raises(error, match=match):
            tkv.kv_row_insert_pair(ck, cv, nk, nv, pos)
        if not fault.startswith("v_"):
            with pytest.raises(error, match=match):
                tkv.kv_row_insert(ck, nk, pos)
        assert (tkv.kv_row_insert.launches, tkv.kv_row_insert_pair.launches) == before


class TestK8:
    @pytest.mark.parametrize("n,d,chunk", [
        (1000, 128, 64),  # N not a multiple of chunk: a ragged tail unread
        (512, 256, 128),
        (300, 128, 8),
    ])
    def test_plain_matches_pallas(self, n, d, chunk):
        rng = np.random.default_rng(n + d + chunk)
        db = rng.integers(-128, 128, (n, d)).astype(np.int8)
        q = rng.integers(-1000, 1000, (8, 128)).astype(np.int32)
        ref = np.asarray(_pallas_stream(jnp.asarray(q), jnp.asarray(db), chunk))
        before = tstream.stream_sum.launches
        out, checksum = tstream.stream_sum(torch.from_numpy(q), torch.from_numpy(db), chunk)
        assert tstream.stream_sum.launches == before
        assert out.dtype == torch.int32 and checksum.dtype == torch.int64
        np.testing.assert_array_equal(out.numpy(), ref)
        rows = n // chunk * chunk
        assert int(checksum) == int(db[:rows].astype(np.int64).sum())

    def test_refuses_what_it_cannot_take(self):
        db = torch.zeros((64, 128), dtype=torch.int8)
        q = torch.zeros((8, 128), dtype=torch.int32)
        with pytest.raises(ValueError, match="corner rows"):
            tstream.stream_sum(q, db, 4)
        with pytest.raises(ValueError, match="columns"):
            tstream.stream_sum(q, db[:, :64], 16)
        with pytest.raises(ValueError, match="int32"):
            tstream.stream_sum(q.long(), db, 16)


class TestProtocol:
    def test_helpers_on_the_cpu(self):
        calls = []

        def body(q, scale):
            calls.append(q.clone())
            return (q * scale, {"sum": q.sum()})

        variants = [torch.full((4, 3), float(v)).unsqueeze(1).expand(4, 2, 3).clone()
                    + torch.arange(4.0)[:, None, None] for v in range(3)]
        ms = bench.time_inprogram(body, variants, extra=(2.0,), reps=3)
        assert ms > 0
        # one warm-up call, then reps passes over S = 4 inputs, variant r % 3
        assert len(calls) == 1 + 3 * 4
        assert all(torch.equal(c, variants[1][i]) for i, c in enumerate(calls[5:9]))
        rtt = bench.measure_rtt(variants[0])
        assert 0 <= rtt < 1
        inputs = list(variants[0])
        assert bench.time_pipelined(lambda q: body(q, 1.0), inputs) > 0
        assert np.isfinite(bench.time_fetch(lambda q: body(q, 1.0), inputs, rtt))


class TestLabSmoke:
    @pytest.mark.parametrize("mode", ["scan", "ladder", "stream", "tail"])
    def test_runs_end_to_end(self, tmp_path, mode):
        path = tmp_path / f"{mode}.json"
        out = lab.main(["--smoke", "--mode", mode, "--out", str(path)])
        assert json.loads(path.read_text()) == json.loads(json.dumps(out))
        assert out["device"] == "cpu" and out["results"]
        if mode in ("scan", "ladder"):
            assert len(out["results"]) == (1 if mode == "scan" else 4)
            assert all(r["recall"] >= 0.5 for r in out["results"])
        elif mode == "stream":
            assert [r["chunk"] for r in out["results"]] == [256, 512]
            assert all(r["rows"] == 3072 for r in out["results"])
        else:
            assert [r["stage"] for r in out["results"]] == [
                "raw scan", "+top_k", "+top_k+rescore"]

    def test_without_smoke_needs_a_card(self, monkeypatch, tmp_path):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            lab.main(["--mode", "stream", "--out", str(tmp_path / "x.json")])


class TestAnatomySmoke:
    def test_every_variant_runs_and_inserts_agree(self, tmp_path):
        path = tmp_path / "anatomy.json"
        before = tkv.kv_row_insert.launches
        before_pair = tkv.kv_row_insert_pair.launches
        out = anatomy.main(["--smoke", "--reps", "2", "--out", str(path)])
        assert json.loads(path.read_text())["rows"] == out["rows"]
        rows = out["rows"]
        for b in (1, 8):
            for v in anatomy.VARIANTS:
                assert rows[f"bf16_b{b}_{v}"] > 0
            for v in anatomy.INSERTS:
                assert rows[f"bf16_b{b}_{v}_agree"] == 1.0
        assert out["calls_per_variant"] == 3 and out["layers"] == 2
        assert tkv.kv_row_insert.launches == before  # CPU: the plain version
        assert tkv.kv_row_insert_pair.launches == before_pair

    def test_insert_variants_write_the_same_cache(self):
        """One step of every insert variant leaves the same per-layer caches
        and tokens as `full`, one lane writing the last row."""
        with torch.inference_mode():
            cfg, params = anatomy.make_model(True, torch.device("cpu"))
            warm, tok = anatomy.warm_cache(params, cfg, 3, 8, 16, np.random.default_rng(1))
            pos = torch.tensor([8, 15, 9], dtype=torch.int32)
            caches = {}
            for v in ("full",) + anatomy.INSERTS:
                ck = [warm.k[i].clone() for i in range(cfg.layers)]
                cv = [warm.v[i].clone() for i in range(cfg.layers)]
                nxt = anatomy.step_variant(params, cfg, tok, ck, cv, pos, v)
                caches[v] = (nxt, ck, cv)
        ref = caches["full"]
        for v in anatomy.INSERTS:
            assert torch.equal(caches[v][0], ref[0])
            for a, b in zip(caches[v][1] + caches[v][2], ref[1] + ref[2]):
                assert torch.equal(a, b)

    def test_int8_weights_run_every_variant(self, tmp_path):
        """`--weights int8`: the tiny decoder with W8A8 weights quantized at
        the source, every variant on the CPU (the GEMM's and the quantize's
        plain versions), the insert variants agreeing with `full`, rows
        named by the weights."""
        before = (w8a8.w8a8_gemm.launches, w8a8.quantize_rows.launches,
                  w8a8.w8a8_qgemm.launches)
        out = anatomy.main(["--smoke", "--reps", "1", "--weights", "int8",
                            "--batches", "2", "--out", str(tmp_path / "a.json")])
        assert out["weights"] == "int8"
        for v in anatomy.VARIANTS:
            assert out["rows"][f"int8_b2_{v}"] > 0
        for v in anatomy.INSERTS:
            assert out["rows"][f"int8_b2_{v}_agree"] == 1.0
        assert not any(k.startswith("bf16") for k in out["rows"])
        assert (w8a8.w8a8_gemm.launches, w8a8.quantize_rows.launches,
                w8a8.w8a8_qgemm.launches) == before
        with torch.inference_mode():
            cfg, params = anatomy.make_model(True, torch.device("cpu"), int8=True)
        assert isinstance(params.layers[0].gate_w, QuantizedLinear)

    def test_refusals(self, monkeypatch):
        with pytest.raises(SystemExit):  # argparse: bf16 or int8 only
            anatomy.main(["--smoke", "--weights", "int4"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            anatomy.main([])


def _sass(body):
    """SASS lines as cuobjdump prints them: /*address*/ opcode operands ;"""
    return [f"        /*{16 * i:04x}*/   {inst} ;   /* 0x0 */" for i, inst in enumerate(body)]


class TestBenchFlash:
    def test_tensor_bound(self):
        # 4 B H T^2 Dh at 989 TFLOP/s: bge-base heads, B 4, T 1024
        assert bench_flash.tensor_bound_ms(4, 12, 1024, 64) == pytest.approx(0.01303, abs=5e-6)
        assert bench_flash.tensor_bound_ms(4, 12, 4096, 64) == pytest.approx(0.20845, abs=5e-6)
        # f32: six bf16 products of the same work
        assert bench_flash.tensor_bound_ms(4, 12, 1024, 64, f32=True) == pytest.approx(
            0.07817, abs=5e-6)

    def test_cuda_core_floor(self):
        scores = 4 * 12 * 1024 * 1024
        fp32 = scores * 12.5 / (132 * 128 * 1980e6) * 1e3
        assert bench_flash.cuda_core_floor_ms(4, 12, 1024, 12.5, 1.0, 1980) == pytest.approx(fp32)
        # 16 MUFU lanes an SM: more than 8 MUFU for each FP32 instruction
        # makes the MUFU the floor
        mufu = scores * 3.0 / (132 * 16 * 1980e6) * 1e3
        assert bench_flash.cuda_core_floor_ms(4, 12, 1024, 12.5, 3.0, 1980) == pytest.approx(mufu)
        assert bench_flash.cuda_core_floor_ms(4, 12, 2048, 12.5, 1.0, 1980) == pytest.approx(
            4 * fp32)

    def test_loop_count_takes_the_short_alternative(self):
        """The loop is the predicated backward branch over the products; of
        an if / else-if / else, only the shortest block counts."""
        body = ["MOV R1, R2", "FADD R0, R1, R2",                  # 0x00: before the loop
                "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ",      # 0x20: the loop
                "@P0 BRA 0x70",
                "FMUL R3, R3, R4", "FADD R3, R3, R5", "BRA 0xc0",    # 0x40: if
                "@P1 BRA 0xb0",                                      # 0x70
                "FMUL R3, R3, R4", "FSEL R3, R3, R5, P1", "BRA 0xc0",  # 0x80: else if
                "FMUL R3, R3, R4",                                   # 0xb0: else
                "MUFU.EX2 R5, R3", "FFMA R6, R5, R5, R5",            # 0xc0: the join
                "@!P2 BRA 0x20", "EXIT"]
        lines = _sass(body)
        counts = bench_flash.main_loop_counts(lines)
        # counted: the products, the else's FMUL, the join's MUFU and FFMA
        assert counts["fp32"] == 2 and counts["mufu"] == 1
        assert counts["skipped_alternatives"] == 2

    def test_loop_count_needs_a_product_loop(self):
        with pytest.raises(ValueError, match="no loop"):
            bench_flash.main_loop_counts(_sass(["FADD R0, R1, R2", "@P0 BRA 0x0", "EXIT"]))

    @pytest.mark.parametrize("dtype_name", ["bfloat16", "float16", "float32"])
    def test_per_score_finds_each_dtypes_kernel(self, dtype_name):
        """The mangled names of the three kernels at Dh 64 and 256: each
        (dtype, Dh) finds its own, 64 scores a thread an iteration."""
        loop = ["HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ", "FADD R0, R1, R2",
                "FMUL R0, R1, R2", "MUFU.EX2 R5, R3", "@P0 BRA 0x0", "EXIT"]
        ns = "_ZN8ragtorch12_GLOBAL__N_1"
        names = {("bfloat16", 64): f"{ns}18flash_wgmma_kernelI13__nv_bfloat16Li64EEEv",
                 ("float16", 64): f"{ns}18flash_wgmma_kernelI6__halfLi64EEEv",
                 ("float32", 64): f"{ns}16flash_f32_kernelILi64EEEv",
                 ("bfloat16", 256): f"{ns}18flash_wgmma_kernelI13__nv_bfloat16Li256EEEv",
                 ("float16", 256): f"{ns}18flash_wgmma_kernelI6__halfLi256EEEv",
                 ("float32", 256): f"{ns}16flash_f32_kernelILi256EEEv"}
        sass = {name: _sass(loop[:1] + ["FADD R0, R1, R2"] * i + loop[1:])
                for i, name in enumerate(names.values())}
        for dh in (64, 256):
            got = bench_flash.per_score(sass, dtype_name, dh)
            extra = list(names).index((dtype_name, dh))
            assert got["fp32"] == 2 + extra and got["fp32_per_score"] == (2 + extra) / 64
            assert got["mufu_per_score"] == 1 / 64
        with pytest.raises(ValueError, match="0 SASS functions"):
            bench_flash.per_score(sass, dtype_name, 128)

    def test_ref_sources_reads_a_ref_and_its_headers(self, tmp_path):
        """--against's sources: the ref's flash source and the headers it
        includes, from git the first time and from build/against after."""
        csrc = tmp_path / "rag_inference_pipeline_tpu_torch" / "csrc"
        csrc.mkdir(parents=True)
        (csrc / "flash_attention.cu").write_text('#include <cuda.h>\n#include "ptx.cuh"\n')
        (csrc / "ptx.cuh").write_text('#pragma once\n#include "tma.cuh"\n')
        (csrc / "tma.cuh").write_text("// the old map\n")
        (csrc / "other.cu").write_text("// not read\n")
        git = ["git", "-C", str(tmp_path), "-c", "user.name=t", "-c", "user.email=t@t"]
        subprocess.run([*git, "init", "-q"], check=True)
        subprocess.run([*git, "add", "-A"], check=True)
        subprocess.run([*git, "commit", "-q", "-m", "parent"], check=True)
        (csrc / "tma.cuh").write_text("// the new map\n")
        subprocess.run([*git, "commit", "-qam", "change"], check=True)
        src = bench_flash.ref_sources("HEAD~1", root=str(tmp_path))
        assert src == str(tmp_path / "build" / "against" / "HEAD~1" / "src")
        assert sorted(os.listdir(src)) == ["flash_attention.cu", "ptx.cuh", "tma.cuh"]
        assert open(os.path.join(src, "tma.cuh")).read() == "// the old map\n"
        shutil.rmtree(tmp_path / ".git")  # a copy without the history finds them
        assert bench_flash.ref_sources("HEAD~1", root=str(tmp_path)) == src
        with pytest.raises(RuntimeError, match="--sources-only"):
            bench_flash.ref_sources("HEAD~2", root=str(tmp_path))

    def test_sources_only_goes_with_against(self, tmp_path):
        with pytest.raises(SystemExit):
            bench_flash.main(["--sources-only", "--out", str(tmp_path / "x.json")])

    def test_smoke_runs_end_to_end(self, tmp_path):
        path = tmp_path / "flash.json"
        out = bench_flash.main(["--smoke", "--out", str(path)])
        assert json.loads(path.read_text()) == json.loads(json.dumps(out))
        assert out["card"] is None and out["sm_clock_mhz"] is None
        cases = out["cases"]
        assert set(cases) == {f"t{t}_h{h}_d{d}_{n}" for t, h, d, n in bench_flash.SMOKE_CASES}
        for (t, h, d, n), row in zip(bench_flash.SMOKE_CASES, cases.values()):
            assert row["finite"] and "ms" not in row  # nothing timed on the CPU
            assert row["tensor_bound_ms"] == bench_flash.tensor_bound_ms(
                4, h, t, d, n == "float32")
        assert out["bert_embed"] == {"t256": {"finite": True}}

    def test_without_smoke_needs_a_card(self, monkeypatch, tmp_path):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_flash.main(["--out", str(tmp_path / "x.json")])

    def test_against_needs_a_card(self, monkeypatch, tmp_path):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_flash.main(["--out", str(tmp_path / "x.json"), "--against", "HEAD"])


class TestBenchW8a8:
    def test_against_takes_llama8b_to_every_turn(self, monkeypatch, tmp_path):
        """--against: parent, change, change, parent, each a process on this
        file (copied into the parent's tools/), --sweep on the first change
        turn only, --llama8b on every turn; the four outputs in order."""
        tools = tmp_path / "parent" / "rag_inference_pipeline_tpu_torch" / "tools"
        tools.mkdir(parents=True)
        monkeypatch.setattr(bench_w8a8, "ROOT", str(tmp_path))
        cmds = []

        def run(cmd, check, stdout):
            cmds.append(cmd)
            out = cmd[cmd.index("--out") + 1]
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "w") as fh:
                json.dump({"turn": len(cmds) - 1}, fh)

        monkeypatch.setattr(bench_w8a8.subprocess, "run", run)
        got = bench_w8a8.against(str(tmp_path / "parent"), sweep=True, llama8b=True)
        assert [(t["tag"], t["turn"]) for t in got["turns"]] == [
            ("parent", 0), ("change", 1), ("change", 2), ("parent", 3)]
        here = os.path.abspath(bench_w8a8.__file__)
        there = str(tools / "bench_w8a8.py")
        assert open(there).read() == open(here).read()
        assert [c[1] for c in cmds] == [there, here, here, there]
        assert all("--llama8b" in c for c in cmds)
        assert ["--sweep" in c for c in cmds] == [False, True, False, False]
        bench_w8a8.against(str(tmp_path / "parent"), sweep=False)
        assert not any("--llama8b" in c or "--sweep" in c for c in cmds[4:])

    def test_against_takes_rows_to_every_turn(self, monkeypatch, tmp_path):
        """--rows with --against: the 17-32-row section alone, in all four
        turns."""
        (tmp_path / "parent" / "rag_inference_pipeline_tpu_torch" / "tools").mkdir(parents=True)
        monkeypatch.setattr(bench_w8a8, "ROOT", str(tmp_path))
        cmds = []

        def run(cmd, check, stdout):
            cmds.append(cmd)
            out = cmd[cmd.index("--out") + 1]
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "w") as fh:
                json.dump({}, fh)

        monkeypatch.setattr(bench_w8a8.subprocess, "run", run)
        bench_w8a8.against(str(tmp_path / "parent"), sweep=False, rows=True)
        assert len(cmds) == 4 and all("--rows" in c and "--llama8b" not in c for c in cmds)

    def test_rows_section_covers_the_engine_rows(self):
        """Every 17-32-row product the section times is a served shape at
        17, 24 and 32 rows, and each lies past the small-row kernels' 16
        rows on the wgmma route."""
        from rag_inference_pipeline_tpu_torch.ops import w8a8

        assert bench_w8a8.ROWS == (17, 24, 32)
        for _, k, _, _ in bench_w8a8.ROWS_SHAPES:
            assert all(w8a8._route(m, k, True) == "wgmma" for m in bench_w8a8.ROWS)

    def test_needs_a_card(self, monkeypatch, tmp_path):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_w8a8.main(["--llama8b", "--out", str(tmp_path / "x.json")])
