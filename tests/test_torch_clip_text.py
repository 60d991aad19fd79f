"""The CLIP text source of the port (`tamtr_torch/data/clip_tokenizer.py`,
`tamtr_torch/nn/clip_text.py`, `tamtr_torch/weight_files.py`, source 2 of
`tamtr_torch/data/text.py`, `tools/encode_texts_torch.py`) against
transformers' `CLIPTokenizer` and `CLIPTextModelWithProjection`, the JAX
package's `data/text.py` and `tools/encode_texts.py`, and the `safetensors`
package, on the CPU: seeded checkpoints of 2 layers at width 64 (128 for the
OpenAI archive, whose heads are width / 64), a byte-level BPE vocabulary of
400 merges learnt from a small corpus, written by `save_pretrained`.
"""

import os
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

os.environ.setdefault("USE_TF", "0")  # transformers' torch classes only: its TensorFlow import costs ~10 s

from tamtr_torch.data import text as PT  # noqa: E402
from tamtr_torch.data.clip_tokenizer import CLIPTokenizer, basic_clean, split_words, train_byte_bpe, write_vocab  # noqa: E402
from tamtr_torch.nn.clip_text import CLIPTextConfig, CLIPTextTower, clip_state_from_transformers  # noqa: E402
from tamtr_torch.weight_files import read_safetensors, read_state, write_safetensors  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

CORPUS = [
    "pedestrian people bicycle car van truck tricycle awning-tricycle bus motor",
    "person bicycle car motorcycle airplane bus train truck boat traffic light fire hydrant stop sign",
    "it's a dog's life, they're here, we've won, I'm ok, you'll see, he'd go, don't 123 4567",
    "café naïve straße 北京 東京 ひらがな 한국어 😀 🚗",
]
ASCII = ["car", "pedestrian", "Awning-tricycle", "Traffic Light", "BUS", "motor", "people", "fire-hydrant"]
CONTRACTIONS = ["it's", "they're here", "WE'VE", "I'm", "you'll", "he'd", "don't", "'S", "2 cars", "route 66",
                "1990s", "½ Ⅻ ²", "!!'s"]
UNICODE = ["café", "naïve Ångström", "Straße", "北京 東京", "ひらがな 한국어", "😀 🚗🚲!!", "tab\tnew\nline\r",
           "nul\x00 bell\x07 bom﻿ rep� zw​", "aͅb", "'ſ", "İstanbul ǅ ﬁ", "é ",
           "<|endoftext|> x<|startoftext|>y <|ENDOFTEXT|>"]
EDGE = ["", "   ", "word " * 80]
TEXTS = ["car", "pedestrian", "Awning-tricycle", "", "it's 12 cafés"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """vocab.json and merges.txt learnt from CORPUS and seeded random words,
    with transformers' tokenizer files saved beside them."""
    from transformers import CLIPTokenizer as HFTokenizer

    rng = np.random.default_rng(0)
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9))) for _ in range(300)]
    encoder, merges = train_byte_bpe(CORPUS + words, 400)
    d = tmp_path_factory.mktemp("clip_vocab")
    write_vocab(d, encoder, merges)
    HFTokenizer(str(d / "vocab.json"), str(d / "merges.txt"), model_max_length=77).save_pretrained(d)
    return d


@pytest.fixture(scope="module")
def hf_tok(vocab_dir):
    from transformers import CLIPTokenizer as HFTokenizer

    return HFTokenizer.from_pretrained(vocab_dir)


def _vocab_size(vocab_dir):
    return len(CLIPTokenizer.from_pretrained(vocab_dir).encoder)


def _text_cfg(V, eos, **kw):
    return dict(vocab_size=V + 8, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                bos_token_id=V - 2, eos_token_id=eos, **kw)


@torch.no_grad()
def _perturb(model, seed):
    """Seeded noise on every parameter: LayerNorms and biases away from 1 and 0."""
    g = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.add_(torch.randn(p.shape, generator=g) * 0.02)
    return model.eval()


CASES = {  # name: (model class, eos, activation, safetensors)
    "text_eos_last": ("text", "last", "quick_gelu", True),
    "text_eos2_gelu_bin": ("text", 2, "gelu", False),
    "full_clip": ("full", "last", "quick_gelu", True),
    "full_clip_bin": ("full", 2, "quick_gelu", False),
}


@pytest.fixture(scope="module")
def checkpoints(vocab_dir, hf_tok, tmp_path_factory):
    """{case: (directory, transformers model, its text-embeds function)}."""
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig as HFConfig, CLIPTextModelWithProjection

    V = _vocab_size(vocab_dir)
    out = {}
    for i, (name, (kind, eos, act, safe)) in enumerate(CASES.items()):
        torch.manual_seed(i)
        text = _text_cfg(V, V - 1 if eos == "last" else eos, hidden_act=act)
        if kind == "text":
            m = _perturb(CLIPTextModelWithProjection(HFConfig(projection_dim=512, **text)), i)
            fn = lambda m, ids, mask: m(input_ids=ids, attention_mask=mask).text_embeds  # noqa: E731
        else:
            vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2,
                          image_size=32, patch_size=16)
            m = _perturb(CLIPModel(CLIPConfig(text_config=text, vision_config=vision, projection_dim=512)), i)
            fn = lambda m, ids, mask: m.get_text_features(input_ids=ids, attention_mask=mask)  # noqa: E731
        d = tmp_path_factory.mktemp(name)
        m.save_pretrained(d, safe_serialization=safe)
        hf_tok.save_pretrained(d)
        out[name] = (d, m, fn)
    return out


# --- tokenizer -------------------------------------------------------------

MODES = {"longest": dict(padding=True), "max_length": dict(padding="max_length", max_length=77, truncation=True)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("group", ["ascii", "contractions_digits", "unicode", "empty_and_long"])
def test_tokenizer_ids_and_masks_equal_transformers(vocab_dir, hf_tok, group, mode):
    texts = {"ascii": ASCII, "contractions_digits": CONTRACTIONS, "unicode": UNICODE, "empty_and_long": EDGE}[group]
    want = hf_tok(texts, return_tensors="pt", **MODES[mode])
    got = CLIPTokenizer.from_pretrained(vocab_dir)(texts, **MODES[mode])
    for k in ("input_ids", "attention_mask"):
        assert got[k].dtype == torch.int64 and torch.equal(got[k], want[k]), (k, texts)
    if group == "empty_and_long":
        width = got["input_ids"].shape[1]
        assert width == 77 if mode == "max_length" else width > 77


def test_tokenizer_equals_transformers_on_random_unicode(vocab_dir, hf_tok):
    """250 seeded strings over every assigned code point below U+30000 and
    the pattern's edge characters."""
    import unicodedata

    rng = np.random.default_rng(1)
    pool = [chr(c) for c in range(0x20, 0x30000) if unicodedata.category(chr(c)) not in ("Cn", "Cs")]
    edge = list(" 'sStTdDmMlLrRvVe!?-.,0123456789<|>") + ["ͅ", "ſ", "İ", " ", "\xa0", "　", "﻿"]
    texts = ["".join(rng.choice(pool, rng.integers(0, 6))) + "".join(rng.choice(edge, rng.integers(0, 10)))
             for _ in range(250)]
    mine = CLIPTokenizer.from_pretrained(vocab_dir)
    bad = [t for t in texts if [mine.bos_token_id] + mine.encode(t) + [mine.eos_token_id] != hf_tok.encode(t)]
    assert not bad, bad[:5]


def test_split_words_is_the_regex_pattern(hf_tok):
    """The scanner against `regex.findall` of CLIPTokenizer's own pattern on
    the cleaned strings."""
    texts = ASCII + CONTRACTIONS + UNICODE + ["!<|endoftext|>", "ab12c", "'ſx", "xͅͅy!ͅ!"]
    for t in texts:
        cleaned = basic_clean(t)
        assert split_words(cleaned) == hf_tok.pat.findall(cleaned), t


def test_tokenizer_reads_added_tokens(vocab_dir, hf_tok, tmp_path):
    """An added token from `added_tokens_decoder`, with rstrip, split out
    of the text as transformers splits it."""
    from transformers import AddedToken

    hf_tok = type(hf_tok).from_pretrained(vocab_dir)
    hf_tok.add_tokens([AddedToken("<obj>", rstrip=True), AddedToken("dog house")])
    hf_tok.save_pretrained(tmp_path)
    texts = ["a <obj>   car", "<obj>dog house cat", "dog house<|endoftext|>"]
    want = hf_tok(texts, padding=True, return_tensors="pt")
    got = CLIPTokenizer.from_pretrained(tmp_path)(texts)
    assert torch.equal(got["input_ids"], want["input_ids"]) and torch.equal(got["attention_mask"],
                                                                           want["attention_mask"])


# --- tower -----------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_tower_matches_transformers(checkpoints, hf_tok, vocab_dir, case):
    """text_embeds within 1e-5: on tokenizer rows in both call modes, and on
    seeded raw ids with the end token at ragged places and ids above it (so
    argmax pooling and first-end pooling pick different positions)."""
    d, m, fn = checkpoints[case]
    tower = CLIPTextTower.from_pretrained(d, device="cpu")
    V = _vocab_size(vocab_dir)
    assert tower.config.eos_token_id == (V - 1 if CASES[case][1] == "last" else 2)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, V + 8, (6, 20)))
    ids[:, 0] = V - 2
    for r, n in enumerate((3, 7, 12, 20, 9, 15)):
        ids[r, n - 1] = V - 1
    mask = torch.ones_like(ids)
    inputs = [(hf_tok(TEXTS, return_tensors="pt", **mode)) for mode in MODES.values()]
    inputs = [(x["input_ids"], x["attention_mask"]) for x in inputs] + [(ids, mask)]
    for x, mk in inputs:
        with torch.no_grad():
            want, got = fn(m, x, mk), tower(x, mk)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_config_defaults_and_full_clip_config():
    c = CLIPTextConfig.from_dict({})
    assert (c.hidden_size, c.num_hidden_layers, c.num_attention_heads, c.intermediate_size, c.vocab_size,
            c.max_position_embeddings, c.hidden_act, c.layer_norm_eps, c.bos_token_id, c.eos_token_id,
            c.projection_dim) == (512, 12, 8, 2048, 49408, 77, "quick_gelu", 1e-5, 49406, 49407, 512)
    c = CLIPTextConfig.from_dict({"model_type": "clip", "projection_dim": 256,
                                  "text_config": {"hidden_size": 64, "eos_token_id": 2, "projection_dim": 512}})
    assert (c.hidden_size, c.eos_token_id, c.projection_dim, c.num_hidden_layers) == (64, 2, 256, 12)
    with pytest.raises(ValueError, match="relu"):
        CLIPTextTower(CLIPTextConfig(hidden_size=64, num_attention_heads=4, num_hidden_layers=1, hidden_act="relu"))


def test_full_clip_reader_skips_the_vision_tower(checkpoints):
    d = checkpoints["full_clip"][0]
    state = clip_state_from_transformers(d)
    assert state and not any("vision" in k or "visual" in k for k in state)
    assert set(state) == set(CLIPTextTower(CLIPTextConfig.from_json(d)).state_dict())


# --- source 2 of data/text.py, against the JAX package ---------------------

def test_encode_texts_and_embedder_match_jax(checkpoints, tmp_path):
    from tamtr_tpu.data import text as JT

    d = str(checkpoints["text_eos_last"][0])
    names = ["person/pedestrian", "car", "Awning-tricycle", "bus"]
    np.testing.assert_allclose(PT.class_text_embeddings(names, clip_model=d, device="cpu"),
                               JT.class_text_embeddings(names, clip_model=d), atol=1e-5, rtol=0)
    texts = ["car", "", "it's 12 cafés", "van"]
    got = PT.encode_texts(texts, clip_model=d, device="cpu")
    np.testing.assert_allclose(got, JT.encode_texts(texts, clip_model=d), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    # npz first, then CLIP for what the table lacks
    table = tmp_path / "t.npz"
    rows = np.random.default_rng(3).standard_normal((2, 512)).astype(np.float32)
    np.savez(table, texts=np.array(["car", "van"], dtype=object), embeddings=rows)
    np.testing.assert_allclose(PT.encode_texts(texts, table, clip_model=d, device="cpu"),
                               JT.encode_texts(texts, table, clip_model=d), atol=1e-5, rtol=0)
    batch = [["car", "bus", ""], ["van", "car", "truck"]]
    np.testing.assert_allclose(PT.TextEmbedder(clip_model=d, device="cpu")(batch),
                               JT.TextEmbedder(clip_model=d)(batch), atol=1e-5, rtol=0)
    assert PT.clip_text_tower(d, "cpu") is PT.clip_text_tower(d, "cpu")  # one tower a (path, device)
    with pytest.raises(ValueError, match="512-d embeddings; the model takes 128"):
        PT.encode_texts(["car"], clip_model=d, dim=128, device="cpu")


def test_clip_source_raises_where_jax_falls_back_to_hash(checkpoints, tmp_path, vocab_dir):
    """JAX's encode_texts swallows any error of its CLIP path and returns
    hash stand-ins; the port raises naming the checkpoint: an unreadable
    checkpoint, a text over 77 tokens under padding=True, and no card when
    no device is given."""
    from tamtr_tpu.data import text as JT

    d = checkpoints["text_eos_last"][0]
    broken = tmp_path / "broken"
    broken.mkdir()
    for f in ("config.json", "vocab.json", "merges.txt", "tokenizer_config.json"):
        (broken / f).write_bytes((d / f).read_bytes())
    (broken / "model.safetensors").write_bytes(b"\x10\x00\x00\x00\x00\x00\x00\x00{not json}")
    long = "word " * 80
    for path, texts in ((broken, ["car"]), (d, ["car", long])):
        np.testing.assert_array_equal(JT.encode_texts(texts, clip_model=str(path)),
                                      np.stack([JT._hash_embedding(t) for t in texts]))
        with pytest.raises(Exception, match=str(path)):
            PT.encode_texts(texts, clip_model=path, device="cpu")
    with pytest.raises(ValueError, match="tokens; the CLIP text tower takes at most 77"):
        PT.encode_texts([long], clip_model=d, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PT.encode_texts(["car"], clip_model=d)


# --- the tool, and the OpenAI archive ---------------------------------------

class _LayerNorm(nn.LayerNorm):
    """OpenAI's fp16-safe LayerNorm: computed in fp32."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class _QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class _Block(nn.Module):
    def __init__(self, d: int, heads: int, mask: torch.Tensor):
        super().__init__()
        self.attn = nn.MultiheadAttention(d, heads)
        self.ln_1 = _LayerNorm(d)
        self.mlp = nn.Sequential(OrderedDict([("c_fc", nn.Linear(d, d * 4)), ("gelu", _QuickGELU()),
                                              ("c_proj", nn.Linear(d * 4, d))]))
        self.ln_2 = _LayerNorm(d)
        self.attn_mask = mask

    def forward(self, x):
        h = self.ln_1(x)
        x = x + self.attn(h, h, h, need_weights=False, attn_mask=self.attn_mask.to(x.dtype))[0]
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, d: int, layers: int, heads: int, mask: torch.Tensor):
        super().__init__()
        self.resblocks = nn.Sequential(*[_Block(d, heads, mask) for _ in range(layers)])

    def forward(self, x):
        return self.resblocks(x)


class _OpenAIText(nn.Module):
    """The text half of the public openai/CLIP `model.py` (CLIP.encode_text),
    with a stand-in `visual` and `logit_scale` as the archive holds them."""

    def __init__(self, vocab: int, d: int, layers: int, ctx: int, proj: int):
        super().__init__()
        mask = torch.full((ctx, ctx), float("-inf")).triu_(1)
        self.visual = nn.Linear(4, 4)
        self.token_embedding = nn.Embedding(vocab, d)
        self.positional_embedding = nn.Parameter(torch.zeros(ctx, d))
        self.transformer = _Transformer(d, layers, d // 64, mask)
        self.ln_final = _LayerNorm(d)
        self.text_projection = nn.Parameter(torch.zeros(d, proj))
        self.logit_scale = nn.Parameter(torch.ones([]))

    @torch.jit.export
    def encode_text(self, text):
        x = self.token_embedding(text) + self.positional_embedding.to(self.token_embedding.weight.dtype)
        x = self.transformer(x.permute(1, 0, 2)).permute(1, 0, 2)
        x = self.ln_final(x)
        return x[torch.arange(x.shape[0]), text.argmax(dim=-1)] @ self.text_projection

    def forward(self, text):
        return self.encode_text(text)


@pytest.fixture(scope="module")
def openai_pair(vocab_dir, hf_tok, tmp_path_factory):
    """A transformers directory (width 128, 2 heads, weights on the fp16
    grid) and an fp16 OpenAI-layout torchscript archive of the same weights."""
    from transformers import CLIPTextConfig as HFConfig, CLIPTextModelWithProjection

    V = _vocab_size(vocab_dir)
    torch.manual_seed(7)
    cfg = HFConfig(**{**_text_cfg(V, V - 1), "hidden_size": 128, "intermediate_size": 512,
                      "num_attention_heads": 2}, projection_dim=512)
    m = _perturb(CLIPTextModelWithProjection(cfg), 7)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(p.half().float())
    d = tmp_path_factory.mktemp("openai_hf")
    m.save_pretrained(d)
    hf_tok.save_pretrained(d)
    t = m.text_model
    oa = _OpenAIText(V + 8, 128, 2, 77, 512)
    with torch.no_grad():
        oa.token_embedding.weight.copy_(t.embeddings.token_embedding.weight)
        oa.positional_embedding.copy_(t.embeddings.position_embedding.weight)
        for blk, layer in zip(oa.transformer.resblocks, t.encoder.layers):
            a = layer.self_attn
            blk.attn.in_proj_weight.copy_(torch.cat([a.q_proj.weight, a.k_proj.weight, a.v_proj.weight]))
            blk.attn.in_proj_bias.copy_(torch.cat([a.q_proj.bias, a.k_proj.bias, a.v_proj.bias]))
            for dst, src in ((blk.attn.out_proj, a.out_proj), (blk.ln_1, layer.layer_norm1),
                             (blk.mlp.c_fc, layer.mlp.fc1), (blk.mlp.c_proj, layer.mlp.fc2),
                             (blk.ln_2, layer.layer_norm2)):
                dst.weight.copy_(src.weight)
                dst.bias.copy_(src.bias)
        oa.ln_final.weight.copy_(t.final_layer_norm.weight)
        oa.ln_final.bias.copy_(t.final_layer_norm.bias)
        oa.text_projection.copy_(m.text_projection.weight.t())
    pt = tmp_path_factory.mktemp("openai_pt") / "ViT-tiny.pt"
    torch.jit.save(torch.jit.script(oa.eval()).half(), str(pt))
    return d, pt


def _run_tools(tmp_path, args_jax, args_port):
    from tools import encode_texts as jax_tool
    from tools import encode_texts_torch as port_tool

    a, b = tmp_path / "jax.npz", tmp_path / "port.npz"
    assert jax_tool.main([*args_jax, "--out", str(a)]) == 0
    assert port_tool.main([*args_port, "--device", "cpu", "--out", str(b)]) == 0
    za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    assert za["texts"].dtype == zb["texts"].dtype == object
    assert list(za["texts"]) == list(zb["texts"])
    return za["embeddings"], zb["embeddings"], list(zb["texts"])


def test_tool_matches_jax_tool_by_model(checkpoints, tmp_path):
    d = str(checkpoints["full_clip"][0])
    data = tmp_path / "data.yaml"
    data.write_text("path: .\ntrain: images\nval: images\nnames:\n  0: person/pedestrian\n  1: car\n"
                    "  2: Awning-tricycle\n")
    want, got, texts = _run_tools(tmp_path, ["--data", str(data), "--texts", "van", "--model", d],
                                  ["--data", str(data), "--texts", "van", "--model", d])
    assert texts == ["van", "person", "pedestrian", "car", "Awning-tricycle", ""]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_openai_archive_reader_matches_jax_and_the_transformers_reader(openai_pair, hf_tok, tmp_path):
    """The port reads the fp16 archive's weights (never calling its code)
    and gives the archive's own encode_text (run by the JAX package's tool)
    and the transformers reader's embeddings on the same weights."""
    from tools import encode_texts as jax_tool
    from tools import encode_texts_torch as port_tool

    d, pt = openai_pair
    texts = ["car", "pedestrian", "", "it's 12 cafés", "word " * 80]
    want = jax_tool.encode_openai_pt(texts, str(pt), tokenizer=hf_tok)
    got = port_tool.encode_openai_pt(texts, str(pt), str(d), device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    hf = port_tool.encode_transformers(texts[:4], str(d), device="cpu")
    np.testing.assert_allclose(got[:4], hf, atol=1e-5, rtol=0)
    # the tools: the port's by --torch-pt, JAX's by --model (its --torch-pt path reads its tokenizer from the hub)
    want, got, _ = _run_tools(tmp_path, ["--texts", *texts[:4], "--model", str(d)],
                              ["--texts", *texts[:4], "--torch-pt", str(pt), "--model", str(d)])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_tool_without_a_checkpoint(tmp_path, capsys):
    from tools import encode_texts as jax_tool
    from tools import encode_texts_torch as port_tool

    missing = str(tmp_path / "nothing")
    assert port_tool.main(["--texts", "car", "--model", missing, "--device", "cpu",
                           "--out", str(tmp_path / "x.npz")]) == 1
    assert missing in capsys.readouterr().err
    want, got, _ = _run_tools(tmp_path, ["--texts", "car", "--model", missing, "--allow-hash"],
                              ["--texts", "car", "--model", missing, "--allow-hash"])
    np.testing.assert_array_equal(got, want)


def test_clip_path_runs_without_transformers_regex_or_jax(checkpoints):
    d = checkpoints["text_eos_last"][0]
    code = (
        "import sys\n"
        "for m in ('jax', 'tamtr_tpu', 'transformers', 'safetensors', 'regex', 'ftfy', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "from tamtr_torch.data.text import encode_texts\n"
        f"e = encode_texts(['car', ''], clip_model={str(d)!r}, device='cpu')\n"
        "assert e.shape == (2, 512)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# --- the safetensors reader -------------------------------------------------

def test_safetensors_reader_is_bitwise_the_package(checkpoints, tmp_path):
    from safetensors.torch import load_file, save_file

    def same(a, b):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert torch.equal(a[k].reshape(-1).view(torch.uint8), b[k].reshape(-1).view(torch.uint8)), k

    f32 = checkpoints["full_clip"][0] / "model.safetensors"
    same(read_safetensors(f32), load_file(f32))
    g = torch.Generator().manual_seed(5)
    tensors = {"a": torch.randn(3, 5, generator=g), "b": torch.randn(7, generator=g).half(),
               "c": torch.randn(2, 3, 4, generator=g).bfloat16(), "s": torch.tensor(2.5), "e": torch.zeros(0, 3)}
    save_file(tensors, tmp_path / "mixed.safetensors", metadata={"format": "pt"})
    same(read_safetensors(tmp_path / "mixed.safetensors"), load_file(tmp_path / "mixed.safetensors"))
    write_safetensors(tensors, tmp_path / "ours.safetensors", metadata={"format": "pt"})
    same(load_file(tmp_path / "ours.safetensors"), tensors)
    save_file({"w": torch.ones(2), "position_ids": torch.arange(4)}, tmp_path / "i64.safetensors")
    with pytest.raises(ValueError, match="'position_ids' is I64"):
        read_safetensors(tmp_path / "i64.safetensors")
    assert list(read_safetensors(tmp_path / "i64.safetensors", lambda k: k != "position_ids")) == ["w"]


def test_read_state_follows_shards_and_bin(checkpoints, tmp_path):
    m = checkpoints["text_eos_last"][1]
    m.save_pretrained(tmp_path / "sharded", max_shard_size="100KB")
    assert (tmp_path / "sharded" / "model.safetensors.index.json").is_file()
    d, m_bin, _ = checkpoints["text_eos2_gelu_bin"]
    for got, model in ((read_state(tmp_path / "sharded"), m), (read_state(d), m_bin),
                       (read_state(d / "pytorch_model.bin"), m_bin)):
        want = {k: v for k, v in model.state_dict().items() if not k.endswith("position_ids")}
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
