"""Caption metrics (the port's copy of
efficientvlm_tpu/evaluation/caption_metrics.py): PTB-style tokenization,
corpus BLEU-1..4 (closest reference length, clipped counts), CIDEr-D (tf-idf
1-4-gram cosine against each reference, the hypothesis weight clipped at
the reference's, a sigma 6 length gaussian, x 10), ROUGE-L (beta 1.2, the
largest precision and recall over the references taken apart) and METEOR
(exact, Porter stem, synonym and paraphrase stages over compact tables;
WordNet synsets only where asked for and installed). Pure Python: no Java
scorer and nothing downloaded; SPICE is reported as None.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List

_PUNCT = re.compile(r"[^a-z0-9 ]")


def ptb_tokenize(s: str) -> List[str]:
    """Lightweight PTB-ish tokenization: lowercase, strip punctuation."""
    s = s.lower().replace("-", " ")
    s = _PUNCT.sub(" ", s)
    return s.split()


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(gts: Dict, res: Dict, max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n (COCO convention: closest ref length,
    clip counts by max ref count). gts/res: id -> list[str]."""
    tot_match = [0] * max_n
    tot_count = [0] * max_n
    len_hyp, len_ref = 0, 0
    for key in res:
        hyp = ptb_tokenize(res[key][0])
        refs = [ptb_tokenize(r) for r in gts[key]]
        len_hyp += len(hyp)
        len_ref += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hc = _ngrams(hyp, n)
            max_ref: Counter = Counter()
            for r in refs:
                rc = _ngrams(r, n)
                for g, c in rc.items():
                    max_ref[g] = max(max_ref[g], c)
            tot_match[n - 1] += sum(min(c, max_ref[g]) for g, c in hc.items())
            tot_count[n - 1] += max(sum(hc.values()), 0)
    bp = 1.0 if len_hyp > len_ref else math.exp(1 - len_ref / max(len_hyp, 1))
    scores = []
    log_sum = 0.0
    for n in range(1, max_n + 1):
        p = tot_match[n - 1] / max(tot_count[n - 1], 1)
        log_sum += math.log(max(p, 1e-12))
        scores.append(bp * math.exp(log_sum / n))
    return scores


class CiderD:
    """CIDEr-D (reference utils/cider/ciderD_scorer.py semantics)."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def _counts(self, s: str):
        toks = ptb_tokenize(s)
        return [_ngrams(toks, k + 1) for k in range(self.n)], len(toks)

    def compute_score(self, gts: Dict, res: Dict):
        keys = list(res.keys())
        # document frequencies over reference sets
        doc_freq = [defaultdict(float) for _ in range(self.n)]
        ref_counts = {}
        for key in keys:
            per_ref = [self._counts(r) for r in gts[key]]
            ref_counts[key] = per_ref
            seen = [set() for _ in range(self.n)]
            for counts, _ in per_ref:
                for k in range(self.n):
                    seen[k].update(counts[k].keys())
            for k in range(self.n):
                for g in seen[k]:
                    doc_freq[k][g] += 1
        log_num_docs = math.log(max(len(keys), 1))

        def vec(counts, length):
            vecs, norms = [], []
            for k in range(self.n):
                v = {}
                norm = 0.0
                for g, c in counts[k].items():
                    df = math.log(max(doc_freq[k][g], 1.0))
                    w = c * (log_num_docs - df)
                    v[g] = w
                    norm += w * w
                vecs.append(v)
                norms.append(math.sqrt(norm))
            return vecs, norms

        scores = []
        for key in keys:
            hyp_counts, hyp_len = self._counts(res[key][0])
            hv, hn = vec(hyp_counts, hyp_len)
            score_k = [0.0] * self.n
            for counts, rlen in ref_counts[key]:
                rv, rn = vec(counts, rlen)
                delta = hyp_len - rlen
                for k in range(self.n):
                    num = 0.0
                    for g, w in hv[k].items():
                        # CIDEr-D clips hyp weight at ref weight
                        num += min(w, rv[k].get(g, 0.0)) * rv[k].get(g, 0.0)
                    if hn[k] > 0 and rn[k] > 0:
                        s = num / (hn[k] * rn[k])
                    else:
                        s = 0.0
                    s *= math.exp(-(delta**2) / (2 * self.sigma**2))
                    score_k[k] += s
            n_refs = max(len(ref_counts[key]), 1)
            scores.append(10.0 * sum(sk / n_refs for sk in score_k) / self.n)
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores


def rouge_l(gts: Dict, res: Dict, beta: float = 1.2) -> float:
    def lcs(a, b):
        m, n = len(a), len(b)
        dp = [0] * (n + 1)
        for i in range(1, m + 1):
            prev = 0
            for j in range(1, n + 1):
                cur = dp[j]
                dp[j] = prev + 1 if a[i - 1] == b[j - 1] else max(dp[j], dp[j - 1])
                prev = cur
        return dp[n]

    total = 0.0
    for key in res:
        hyp = ptb_tokenize(res[key][0])
        # official pycocoevalcap semantics (refTools rouge.py calc_score):
        # max PRECISION and max RECALL are taken SEPARATELY across the
        # references (possibly from different refs) before the F-beta
        # combine — not the max of per-ref F scores
        precs, recs = [], []
        for r in gts[key]:
            ref = ptb_tokenize(r)
            l = lcs(ref, hyp)
            precs.append(l / max(len(hyp), 1))
            recs.append(l / max(len(ref), 1))
        prec, rec = max(precs), max(recs)
        if prec and rec:
            total += (1 + beta**2) * prec * rec / (rec + beta**2 * prec)
    return total / max(len(res), 1)


# ---------------------------------------------------------------------------
# METEOR (pure-Python)
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _porter_stem(w: str) -> str:
    """Compact Porter stemmer (steps 1a/1b/1c + common step-2..4 suffixes) —
    enough for METEOR's stem-match stage; not a full linguistics package."""
    if len(w) <= 2:
        return w

    def has_vowel(s):
        return any(c in _VOWELS or (c == "y" and i > 0) for i, c in enumerate(s))

    def measure(s):
        m, prev_v = 0, False
        for i, c in enumerate(s):
            v = c in _VOWELS or (c == "y" and i > 0 and s[i - 1] not in _VOWELS)
            if prev_v and not v:
                m += 1
            prev_v = v
        return m

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    if w.endswith("eed"):
        if measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and has_vowel(w[:-2]):
        w = w[:-2]
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif len(w) > 1 and w[-1] == w[-2] and w[-1] not in "lsz":
            w = w[:-1]
        elif (measure(w) == 1 and len(w) >= 3 and w[-1] not in _VOWELS + "wxy"
              and w[-2] in _VOWELS and w[-3] not in _VOWELS):
            w += "e"
    elif w.endswith("ing") and has_vowel(w[:-3]):
        w = w[:-3]
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif len(w) > 1 and w[-1] == w[-2] and w[-1] not in "lsz":
            w = w[:-1]
    # step 1c
    if w.endswith("y") and has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # a few high-frequency step-2/3/4 suffixes
    for suf, rep, min_m in (
        ("ational", "ate", 0), ("tional", "tion", 0), ("ization", "ize", 0),
        ("fulness", "ful", 0), ("ousness", "ous", 0), ("iveness", "ive", 0),
        ("biliti", "ble", 0), ("aliti", "al", 0), ("ation", "ate", 0),
        ("alism", "al", 0), ("ement", "", 1), ("ment", "", 1), ("ness", "", 0),
        ("icate", "ic", 0), ("ative", "", 1), ("alize", "al", 0),
        ("ful", "", 0), ("ance", "", 1), ("ence", "", 1), ("able", "", 1),
        ("ible", "", 1), ("ant", "", 1), ("ion", "", 1), ("ous", "", 1),
        ("ive", "", 1), ("ize", "", 1), ("al", "", 1), ("er", "", 1),
        ("ic", "", 1),
    ):
        if w.endswith(suf) and measure(w[: -len(suf)]) > min_m:
            w = w[: -len(suf)] + rep
            break
    return w


# -- synonym matcher (METEOR stage 3) ---------------------------------------
# java METEOR 1.5 (reference refTools/evaluation/meteor/meteor.py drives
# meteor-1.5.jar) matches words that share a WordNet synset. WordNet data is
# not shipped with the package (nothing is downloaded), so the synonym stage runs on a
# vendored compact table of common caption/VQA-domain synonym groups by
# DEFAULT (deterministic provenance); real WordNet synsets are
# an explicit opt-in via meteor(synonym_source="wordnet").
_SYNONYM_GROUPS = [
    ("picture", "photo", "photograph", "image", "snapshot"),
    ("big", "large", "huge", "enormous", "giant"),
    ("small", "little", "tiny"),
    ("man", "guy", "male", "gentleman"),
    ("woman", "lady", "female"),
    ("kid", "child", "youngster"),
    ("kids", "children"),
    ("people", "persons", "folks"),
    ("street", "road", "roadway"),
    ("car", "automobile", "auto"),
    ("bike", "bicycle", "cycle"),
    ("motorbike", "motorcycle"),
    ("bus", "coach"),
    ("plane", "airplane", "aircraft", "jet"),
    ("boat", "ship", "vessel"),
    ("couch", "sofa"),
    ("tv", "television"),
    ("cellphone", "phone", "telephone", "mobile"),
    ("computer", "pc", "laptop"),
    ("fridge", "refrigerator"),
    ("stove", "oven", "range"),
    ("sidewalk", "pavement"),
    ("store", "shop", "market"),
    ("home", "house", "residence"),
    ("sea", "ocean"),
    ("rock", "stone", "boulder"),
    ("forest", "woods", "woodland"),
    ("hill", "mound"),
    ("trail", "path", "track"),
    ("dog", "canine", "pup", "puppy"),
    ("cat", "kitten", "kitty", "feline"),
    ("bird", "fowl"),
    ("cow", "cattle", "bovine"),
    ("horse", "pony", "stallion", "mare"),
    ("rabbit", "bunny", "hare"),
    ("pig", "hog", "swine"),
    ("baby", "infant", "toddler"),
    ("food", "meal", "dish", "cuisine"),
    ("sandwich", "sub", "hoagie"),
    ("fries", "chips"),
    ("soda", "pop", "cola"),
    ("dessert", "sweet", "pudding"),
    ("cup", "mug"),
    ("plate", "dish", "platter"),
    ("couple", "pair", "duo"),
    ("group", "crowd", "bunch", "gathering"),
    ("hat", "cap"),
    ("jacket", "coat"),
    ("pants", "trousers", "slacks"),
    ("shoes", "footwear", "sneakers"),
    ("bag", "sack", "pouch"),
    ("purse", "handbag"),
    ("luggage", "baggage", "suitcase"),
    ("happy", "glad", "joyful", "cheerful"),
    ("sad", "unhappy", "gloomy"),
    ("angry", "mad", "furious"),
    ("fast", "quick", "rapid", "speedy"),
    ("slow", "sluggish"),
    ("pretty", "beautiful", "lovely", "gorgeous", "attractive"),
    ("ugly", "unattractive", "hideous"),
    ("old", "elderly", "aged", "ancient"),
    ("young", "youthful", "juvenile"),
    ("clean", "spotless", "tidy"),
    ("dirty", "filthy", "grimy", "soiled"),
    ("wet", "damp", "moist", "soaked"),
    ("dry", "arid", "parched"),
    ("cold", "chilly", "freezing", "frigid"),
    ("hot", "warm", "heated"),
    ("bright", "brilliant", "radiant", "luminous"),
    ("dark", "dim", "shadowy", "murky"),
    ("near", "close", "nearby"),
    ("far", "distant", "remote"),
    ("begin", "start", "commence"),
    ("end", "finish", "conclude"),
    ("walk", "stroll", "amble"),
    ("run", "sprint", "jog", "dash"),
    ("jump", "leap", "hop", "bound"),
    ("throw", "toss", "hurl", "fling"),
    ("catch", "grab", "snag"),
    ("hold", "grip", "grasp", "clutch"),
    ("look", "gaze", "stare", "glance", "watch"),
    ("see", "observe", "view", "spot"),
    ("talk", "speak", "chat", "converse"),
    ("eat", "consume", "devour", "dine"),
    ("drink", "sip", "gulp"),
    ("sleep", "doze", "snooze", "slumber"),
    ("sit", "perch"),
    ("stand", "rise"),
    ("ride", "mount"),
    ("carry", "haul", "lug", "tote"),
    ("pull", "tug", "drag", "tow"),
    ("push", "shove", "press"),
    ("cut", "slice", "chop", "carve"),
    ("fix", "repair", "mend"),
    ("make", "build", "construct", "create"),
    ("show", "display", "exhibit", "present"),
    ("smile", "grin", "beam"),
    ("laugh", "chuckle", "giggle"),
    ("cry", "weep", "sob"),
    ("shout", "yell", "scream", "holler"),
    ("wave", "gesture", "signal"),
    ("play", "frolic", "romp"),
    ("buy", "purchase"),
    ("sell", "vend"),
    ("give", "hand", "pass"),
    ("get", "obtain", "receive", "acquire"),
    ("put", "place", "set", "lay"),
    ("keep", "retain", "store"),
    ("open", "unlock"),
    ("close", "shut", "seal"),
    ("turn", "rotate", "spin", "twist"),
    ("move", "shift", "relocate"),
    ("stop", "halt", "cease", "pause"),
    ("wait", "linger", "stay"),
    ("help", "assist", "aid"),
    ("need", "require"),
    ("want", "desire", "wish"),
    ("like", "enjoy", "love", "adore"),
    ("fly", "soar", "glide"),
    ("swim", "paddle", "wade"),
    ("climb", "scale", "ascend"),
    ("fall", "drop", "tumble", "plunge"),
    ("street", "avenue", "boulevard", "lane"),
    ("field", "meadow", "pasture"),
    ("river", "stream", "creek", "brook"),
    ("lake", "pond", "lagoon"),
    ("mountain", "peak", "summit"),
    ("building", "structure", "edifice"),
    ("shop", "boutique", "outlet"),
    ("restaurant", "diner", "eatery", "cafe"),
    ("kitchen", "galley"),
    ("bathroom", "restroom", "washroom", "lavatory", "toilet"),
    ("bedroom", "chamber"),
    ("garden", "yard", "lawn"),
    ("fence", "barrier", "railing"),
    ("wall", "partition"),
    ("roof", "rooftop"),
    ("window", "pane"),
    ("door", "doorway", "entrance", "entry"),
    ("table", "desk", "counter"),
    ("chair", "seat", "stool"),
    ("bed", "mattress", "cot"),
    ("light", "lamp", "lantern"),
    ("floor", "ground"),
    ("ceiling", "overhead"),
    ("stairs", "staircase", "stairway", "steps"),
    ("sign", "signpost", "placard", "billboard"),
    ("flag", "banner", "pennant"),
    ("clock", "timepiece"),
    ("mirror", "reflection"),
    ("box", "crate", "carton", "container"),
    ("bottle", "flask", "jar"),
    ("knife", "blade"),
    ("gift", "present"),
    ("toy", "plaything"),
    ("ball", "sphere", "orb"),
    ("game", "match", "contest"),
    ("player", "athlete", "competitor"),
    ("team", "squad", "crew"),
    ("race", "competition"),
    ("crowd", "audience", "spectators"),
    ("trash", "garbage", "rubbish", "waste", "litter"),
    ("money", "cash", "currency"),
    ("job", "work", "occupation", "profession"),
    ("doctor", "physician"),
    ("cop", "police", "officer"),
    ("firefighter", "fireman"),
    ("teacher", "instructor", "tutor"),
    ("student", "pupil", "learner"),
    ("friend", "pal", "buddy", "companion"),
    ("enemy", "foe", "adversary"),
    ("boss", "chief", "leader", "manager"),
    ("truck", "lorry", "rig"),
    ("taxi", "cab"),
    ("train", "railway", "locomotive"),
    ("subway", "metro", "underground"),
    ("engine", "motor"),
    ("wheel", "tire", "tyre"),
    ("fire", "flame", "blaze"),
    ("smoke", "fumes"),
    ("rain", "rainfall", "drizzle", "shower"),
    ("snow", "snowfall"),
    ("wind", "breeze", "gust"),
    ("storm", "tempest"),
    ("cloud", "clouds", "overcast"),
    ("sun", "sunshine", "sunlight"),
    ("night", "nighttime", "evening"),
    ("day", "daytime", "daylight"),
]
_SYN_IDS: Dict[str, set] = {}
for _gid, _group in enumerate(_SYNONYM_GROUPS):
    for _w in _group:
        _SYN_IDS.setdefault(_w, set()).add(_gid)

# -- paraphrase matcher (METEOR stage 4) -------------------------------------
# java METEOR 1.5's final matcher stage aligns multi-word PHRASES through a
# paraphrase table (data/paraphrase-en.gz, derived from bilingual phrase
# tables). That table is ~50MB and not shipped (nothing is downloaded); this
# is a compact vendored equivalent covering common caption-domain phrase
# equivalences, wired through the same stage interface so the matcher order
# (exact -> stem -> synonym -> paraphrase) matches METEOR 1.5 exactly.
# Entries are tuples of space-joined token phrases (1-4 words) that may
# align with each other when the underlying token spans are still unmatched.
_PARAPHRASE_GROUPS = [
    ("in front of", "before", "ahead of"),
    ("next to", "beside", "alongside", "adjacent to"),
    ("close to", "near", "nearby"),
    ("on top of", "atop", "above"),
    ("a lot of", "lots of", "many", "plenty of"),
    ("a couple of", "a few", "several"),
    ("a group of", "a bunch of", "a crowd of"),
    ("a number of", "numerous"),
    ("in the middle of", "in the center of", "amid"),
    ("each other", "one another"),
    ("right now", "currently", "at the moment"),
    ("get on", "board", "climb onto"),
    ("get off", "exit", "climb off"),
    ("looking at", "watching", "gazing at"),
    ("sitting on", "seated on", "perched on"),
    ("standing next to", "standing beside"),
    ("young man", "boy", "young male"),
    ("young woman", "girl", "young female"),
    ("young child", "little kid", "small child"),
    ("cell phone", "mobile phone", "cellphone"),
    ("television set", "tv", "television"),
    ("fire hydrant", "hydrant"),
    ("stop sign", "stop signal"),
    ("parking lot", "car park"),
    ("living room", "lounge", "sitting room"),
    ("hot dog", "hotdog", "frankfurter"),
    ("teddy bear", "stuffed bear", "stuffed animal"),
    ("next to the", "beside the"),
    ("is able to", "can"),
    ("in order to", "to"),
    ("a man and a woman", "a couple"),
    ("riding on", "riding atop", "astride"),
]
_PARA_IDS: Dict[str, set] = {}
_PARA_MAX_LEN = 1
for _gid, _group in enumerate(_PARAPHRASE_GROUPS):
    for _p in _group:
        _PARA_IDS.setdefault(_p, set()).add(_gid)
        _PARA_MAX_LEN = max(_PARA_MAX_LEN, len(_p.split()))

_WORDNET = None
_WORDNET_TRIED = False


def _wordnet_or_none():
    """Real WordNet synsets when the nltk corpus is installed, else None
    (table fallback). Cached after the first probe."""
    global _WORDNET, _WORDNET_TRIED
    if not _WORDNET_TRIED:
        _WORDNET_TRIED = True
        try:
            from nltk.corpus import wordnet

            wordnet.synsets("dog")  # raises LookupError if corpus data absent
            _WORDNET = wordnet
        except Exception:  # noqa: BLE001 — any failure means "no corpus"
            _WORDNET = None
    return _WORDNET


_WN_CACHE: Dict[str, frozenset] = {}


def _synset_ids(word: str, use_wordnet: bool = False) -> frozenset:
    wn = _wordnet_or_none() if use_wordnet else None
    if wn is None:
        return frozenset(_SYN_IDS.get(word, ()))
    got = _WN_CACHE.get(word)
    if got is None:
        got = frozenset(s.name() for s in wn.synsets(word))
        _WN_CACHE[word] = got
    return got


def _is_synonym(a: str, b: str, use_wordnet: bool = False) -> bool:
    if a == b:
        return False  # exact stage already handled identity
    sa = _synset_ids(a, use_wordnet)
    return bool(sa) and not sa.isdisjoint(_synset_ids(b, use_wordnet))


def _meteor_match(cand: List[str], ref: List[str], use_wordnet: bool = False):
    """Four-stage greedy alignment in the java METEOR 1.5 matcher order
    (exact, Porter stem, synonym, paraphrase — reference refTools/evaluation/
    meteor/meteor.py drives meteor-1.5.jar with the same stage sequence).
    Word stages match left-to-right, preferring the reference position
    nearest after the previous match (keeps chunks low); the paraphrase
    stage aligns still-unmatched contiguous token SPANS through the vendored
    table, longest candidate span first. Returns (m_c, m_r, chunks): matched
    word counts on the candidate and reference sides (they differ when a
    paraphrase aligns spans of different lengths) and the chunk count over
    match units."""
    used = [False] * len(ref)
    align = [-1] * len(cand)
    # span matches as (ci, cn, rj, rn); word matches are n==1 spans
    spans = []

    def run_stage(key_c, key_r, match=None):
        last = -1
        for i, tc in enumerate(key_c):
            if align[i] >= 0:
                last = align[i]
                continue
            best = -1
            for j, tr in enumerate(key_r):
                if used[j] or not (tc == tr if match is None else match(tc, tr)):
                    continue
                if best < 0 or abs(j - (last + 1)) < abs(best - (last + 1)):
                    best = j
            if best >= 0:
                align[i] = best
                used[best] = True
                last = best
                spans.append((i, 1, best, 1))

    run_stage(cand, ref)
    run_stage([_porter_stem(t) for t in cand], [_porter_stem(t) for t in ref])
    run_stage(cand, ref, match=lambda a, b: _is_synonym(a, b, use_wordnet))

    # stage 4: paraphrase spans over whatever the word stages left unmatched
    for n_c in range(min(_PARA_MAX_LEN, len(cand)), 0, -1):
        for i in range(len(cand) - n_c + 1):
            if any(align[t] >= 0 for t in range(i, i + n_c)):
                continue
            gids = _PARA_IDS.get(" ".join(cand[i:i + n_c]))
            if not gids:
                continue
            hit = None
            for n_r in range(min(_PARA_MAX_LEN, len(ref)), 0, -1):
                for j in range(len(ref) - n_r + 1):
                    if any(used[t] for t in range(j, j + n_r)):
                        continue
                    rg = _PARA_IDS.get(" ".join(ref[j:j + n_r]))
                    if rg and not gids.isdisjoint(rg):
                        hit = (j, n_r)
                        break
                if hit:
                    break
            if hit:
                j, n_r = hit
                for t in range(i, i + n_c):
                    align[t] = j  # covered (span bookkeeping in `spans`)
                for t in range(j, j + n_r):
                    used[t] = True
                spans.append((i, n_c, j, n_r))

    if not spans:
        return 0, 0, 0
    spans.sort()
    m_c = sum(cn for _, cn, _, _ in spans)
    m_r = sum(rn for _, _, _, rn in spans)
    chunks = 1
    for (i0, cn0, j0, rn0), (i1, _, j1, _) in zip(spans, spans[1:]):
        if not (i1 == i0 + cn0 and j1 == j0 + rn0):
            chunks += 1
    return m_c, m_r, chunks


def meteor(gts: Dict, res: Dict, *, alpha: float = 0.9, beta: float = 3.0,
           gamma: float = 0.5, synonym_source: str = "table") -> float:
    """Pure-Python METEOR with the full METEOR 1.5 matcher sequence (exact,
    Porter stem, synonym, paraphrase — the java scorer the reference vendors
    in refTools/evaluation/meteor). Scores are band-comparable to java
    METEOR 1.5 rather than bit-exact: its tuned per-stage match weights and
    50MB paraphrase table are replaced by unit weights and the compact
    vendored table (tests/test_metrics.py pins the 4-stage alignment math on
    hand-computed goldens).

    synonym_source makes score provenance DETERMINISTIC: "table"
    (default) always uses the vendored synonym table; "wordnet" requires the
    nltk WordNet corpus and raises if absent — no silent environment-
    dependent matcher switch.

    Classic formula: Fmean with recall weight alpha, fragmentation penalty
    gamma*(chunks/m)^beta with m the mean matched-word count (candidate and
    reference sides differ only for unequal-length paraphrase spans);
    multiple references take the max."""
    if synonym_source not in ("table", "wordnet"):
        raise ValueError(f"synonym_source must be 'table' or 'wordnet', got {synonym_source!r}")
    use_wordnet = synonym_source == "wordnet"
    if use_wordnet and _wordnet_or_none() is None:
        raise RuntimeError("synonym_source='wordnet' but the nltk WordNet corpus is not installed")
    total = 0.0
    for iid in res:
        cand = ptb_tokenize(res[iid][0])
        best = 0.0
        for r in gts[iid]:
            ref = ptb_tokenize(r)
            if not cand or not ref:
                continue
            m_c, m_r, chunks = _meteor_match(cand, ref, use_wordnet)
            if m_c == 0:
                continue
            p = m_c / len(cand)
            q = m_r / len(ref)
            fmean = p * q / (alpha * p + (1 - alpha) * q)
            m = 0.5 * (m_c + m_r)
            frag = gamma * (chunks / m) ** beta
            best = max(best, fmean * (1.0 - frag))
        total += best
    return total / max(len(res), 1)


def coco_caption_eval(annotations: List[dict], results: List[dict]) -> dict:
    """reference dataset/utils.py:356-382 interface: annotations/results are
    [{'image_id', 'caption'}]. Returns the COCO metric dict."""
    gts: Dict = defaultdict(list)
    for a in annotations:
        gts[a["image_id"]].append(a["caption"])
    res: Dict = {}
    for r in results:
        res[r["image_id"]] = [r["caption"]]
    res = {k: v for k, v in res.items() if k in gts}
    gts = {k: gts[k] for k in res}
    b = bleu(gts, res)
    cider, _ = CiderD().compute_score(gts, res)
    return {
        "Bleu_1": b[0], "Bleu_2": b[1], "Bleu_3": b[2], "Bleu_4": b[3],
        "ROUGE_L": rouge_l(gts, res),
        "CIDEr": cider,
        # pure-Python 4-stage matcher; deterministic vendored-table synonyms
        "METEOR": meteor(gts, res, synonym_source="table"),
        "METEOR_matcher": "table",  # score provenance is explicit
        # SPICE needs a java scene-graph parser. The reference's own vendored
        # refTools/evaluation ships NO spice scorer either (only
        # bleu/cider/meteor/rouge; dataset/utils.py:372 merely mentions it in
        # a comment) — so None here is exact parity with what the reference
        # repo can compute, reported explicitly rather than silently dropped.
        "SPICE": None,
    }
