// spumoni_native.cpp — native index-construction + CPU query engine for the
// TPU-native matching-statistics framework (spumoni_tpu).
//
// This replaces the reference's external build pipeline (Big-BWT `newscan.x`,
// `pfp_thresholds`, RePair/SLP chain invoked as subprocesses from
// /root/reference/src/spumoni.cpp:442-545) with a single in-process library:
//   * SA-IS suffix-array construction (induced sorting, Nong-Zhang-Chan)
//   * Kasai LCP
//   * run-length BWT extraction (runs, heads, lengths)
//   * Bannai-Gagie-I thresholds per run (leftmost LCP argmin between
//     consecutive same-character runs; first run of a char gets 0 — matches
//     the convention asserted by /root/reference/include/thresholds_ds.hpp:422-423)
//   * SA samples at run boundaries (raw SA values; the Python layer applies
//     the (sa - 1) mod n convention of
//     /root/reference/src/compute_ms_pml.cpp:431-434)
//
// It also provides a dense-array CPU query engine implementing the exact
// MS/PML streaming recurrence of /root/reference/src/compute_ms_pml.cpp:237-286
// and :570-623, with rank/select realized as binary searches over per-character
// run tables — the same layout the device kernels use. This doubles as
// (a) the measured multi-thread CPU baseline, and (b) the oracle for JAX
// engine parity tests.
//
// No code is copied from the reference; the algorithms are reimplemented from
// their published descriptions.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <chrono>
#include <vector>
#include <algorithm>
#include <thread>
#include <atomic>
#include <functional>
#include <string>
#include <string_view>
#include <unordered_map>

typedef int64_t i64;
typedef int32_t i32;
typedef uint64_t u64;
typedef uint8_t u8;

// ---------------------------------------------------------------------------
// SA-IS (suffix array by induced sorting)
// s has length n and s[n-1] is the unique smallest character (sentinel).
// ---------------------------------------------------------------------------

namespace {

template <typename char_t, typename idx_t>
void sais_rec(const char_t* s, idx_t* SA, idx_t n, idx_t K) {
    if (n == 1) { SA[0] = 0; return; }
    std::vector<u8> t(n);
    t[n - 1] = 1;  // sentinel is S-type
    for (idx_t i = n - 2; i >= 0; --i)
        t[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[i + 1]);
    auto isLMS = [&](idx_t i) { return i > 0 && t[i] && !t[i - 1]; };

    std::vector<idx_t> bkt(K);
    auto get_buckets = [&](bool end) {
        std::fill(bkt.begin(), bkt.end(), (idx_t)0);
        for (idx_t i = 0; i < n; ++i) bkt[(idx_t)s[i]]++;
        idx_t sum = 0;
        for (idx_t i = 0; i < K; ++i) {
            sum += bkt[i];
            bkt[i] = end ? sum : sum - bkt[i];
        }
    };
    auto induce = [&]() {
        // induce L-type from sorted LMS/S positions
        get_buckets(false);
        for (idx_t i = 0; i < n; ++i) {
            idx_t j = SA[i] - 1;
            if (SA[i] > 0 && !t[j]) SA[bkt[(idx_t)s[j]]++] = j;
        }
        // induce S-type
        get_buckets(true);
        for (idx_t i = n - 1; i >= 0; --i) {
            idx_t j = SA[i] - 1;
            if (SA[i] > 0 && t[j]) SA[--bkt[(idx_t)s[j]]] = j;
        }
    };

    // Stage 1: place LMS suffixes at bucket ends, induce-sort LMS substrings.
    std::fill(SA, SA + n, (idx_t)-1);
    get_buckets(true);
    for (idx_t i = 1; i < n; ++i)
        if (isLMS(i)) SA[--bkt[(idx_t)s[i]]] = i;
    induce();

    // Compact sorted LMS positions into SA[0..n1).
    idx_t n1 = 0;
    for (idx_t i = 0; i < n; ++i)
        if (SA[i] > 0 && isLMS(SA[i])) SA[n1++] = SA[i];

    // Name LMS substrings in SA[n1..n).
    std::fill(SA + n1, SA + n, (idx_t)-1);
    idx_t name = 0, prev = -1;
    for (idx_t i = 0; i < n1; ++i) {
        idx_t pos = SA[i];
        bool diff = false;
        for (idx_t d = 0; d < n; ++d) {
            if (prev == -1 || pos + d == n - 1 || prev + d == n - 1 ||
                s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
                diff = true;
                break;
            }
            if (d > 0 && (isLMS(pos + d) || isLMS(prev + d))) break;
        }
        if (diff) { ++name; prev = pos; }
        SA[n1 + pos / 2] = name - 1;
    }
    for (idx_t i = n - 1, j = n - 1; i >= n1; --i)
        if (SA[i] >= 0) SA[j--] = SA[i];

    // Stage 2: recurse on the reduced string if names are not unique.
    idx_t* SA1 = SA;
    idx_t* s1 = SA + n - n1;
    if (name < n1) {
        sais_rec<idx_t, idx_t>(s1, SA1, n1, name);
    } else {
        for (idx_t i = 0; i < n1; ++i) SA1[s1[i]] = i;
    }

    // Stage 3: induce the full SA from the sorted LMS suffixes.
    std::vector<idx_t> lms;
    lms.reserve(n1);
    for (idx_t i = 1; i < n; ++i)
        if (isLMS(i)) lms.push_back(i);
    for (idx_t i = 0; i < n1; ++i) SA1[i] = lms[SA1[i]];
    std::fill(SA + n1, SA + n, (idx_t)-1);
    get_buckets(true);
    for (idx_t i = n1 - 1; i >= 0; --i) {
        idx_t j = SA1[i];
        SA1[i] = -1;
        SA[--bkt[(idx_t)s[j]]] = j;
    }
    induce();
}

}  // namespace

extern "C" {

// Computes the suffix array of text+sentinel. `sa_out` must have n+1 slots.
// The sentinel (value 0, strictly smaller than all text bytes) is appended
// internally; text bytes must be >= 1. Returns 0 on success.
int spn_suffix_array(const u8* text, i64 n, i64* sa_out) {
    std::vector<u8> s(n + 1);
    for (i64 i = 0; i < n; ++i) {
        if (text[i] == 0) return -1;
        s[i] = text[i];
    }
    s[n] = 0;
    sais_rec<u8, i64>(s.data(), sa_out, n + 1, 256);
    return 0;
}

}  // extern "C" (reopened below; templates need C++ linkage)

// ---------------------------------------------------------------------------
// Full index build: BWT runs + thresholds + SA samples.
//
// Outputs are exposed through getters after spn_build() so Python can size
// numpy buffers from spn_num_runs().
// ---------------------------------------------------------------------------

struct SpnIndex {
    i64 n = 0;        // BWT length = text length + 1 (terminator)
    i64 r = 0;        // number of runs
    std::vector<u8> run_heads;       // [r] run characters (terminator coerced to 1,
                                     //     mirroring ms_rle_string.hpp:66-68)
    std::vector<i64> run_starts;     // [r] BWT position of each run start
    std::vector<i64> thresholds;     // [r] absolute threshold position (0 for the
                                     //     first run of each character)
    std::vector<i64> samples_start;  // [r] raw SA value at run start
    std::vector<i64> samples_last;   // [r] raw SA value at run end
    std::vector<i64> lcp_dbg;        // SPN_DEBUG_LCP=1: streamed LCP values
};

template <typename idx_t>
static SpnIndex* spn_build_core(const u8* text, i64 text_len) {
    idx_t n = (idx_t)(text_len + 1);
    std::vector<u8> s(n);
    std::memcpy(s.data(), text, text_len);
    s[text_len] = 0;  // sentinel

    std::vector<idx_t> sa(n);
    sais_rec<u8, idx_t>(s.data(), sa.data(), n, 256);

    // BWT
    std::vector<u8> bwt(n);
    for (idx_t i = 0; i < n; ++i) {
        idx_t j = sa[i];
        u8 c = (j > 0) ? s[j - 1] : s[n - 1];
        bwt[i] = (c <= 1) ? 1 : c;  // coerce terminator to 1
    }

    // Kasai LCP: lcp[i] = LCP(suffix SA[i-1], suffix SA[i]), lcp[0] = 0.
    std::vector<idx_t> rank(n), lcp(n, 0);
    for (idx_t i = 0; i < n; ++i) rank[sa[i]] = i;
    idx_t h = 0;
    for (idx_t i = 0; i < n; ++i) {
        if (rank[i] > 0) {
            idx_t j = sa[rank[i] - 1];
            while (i + h < n && j + h < n && s[i + h] == s[j + h]) ++h;
            lcp[rank[i]] = h;
            if (h > 0) --h;
        } else {
            h = 0;
        }
    }

    SpnIndex* idx = new SpnIndex();
    idx->n = n;

    // Runs
    for (idx_t i = 0; i < n; ++i) {
        if (i == 0 || bwt[i] != bwt[i - 1]) {
            idx->run_heads.push_back(bwt[i]);
            idx->run_starts.push_back(i);
            idx->samples_start.push_back(sa[i]);
            idx->samples_last.push_back(sa[i]);
        } else {
            idx->samples_last.back() = sa[i];
        }
    }
    idx->r = (i64)idx->run_heads.size();
    idx->thresholds.assign(idx->r, 0);

    // Thresholds: for each run k with head c that is not the first run of c,
    // the threshold is the leftmost argmin of LCP over (prev_end, run_start],
    // where prev_end is the (inclusive) end of the previous run of c.
    // For the first run of a char the threshold stays 0
    // (thresholds_ds.hpp:478-491 returns 0 when run_head_rank == 0).
    {
        i64 prev_end_of_char[256];
        i64 prev_run_of_char[256];
        for (int c = 0; c < 256; ++c) prev_run_of_char[c] = -1;
        for (i64 k = 0; k < idx->r; ++k) {
            u8 c = idx->run_heads[k];
            i64 start = idx->run_starts[k];
            i64 end = (k + 1 < idx->r) ? idx->run_starts[k + 1] - 1 : n - 1;
            if (prev_run_of_char[c] >= 0) {
                i64 lo = prev_end_of_char[c] + 1;  // in [1, n)
                i64 best_pos = lo;
                i64 best = lcp[lo];
                for (i64 p = lo + 1; p <= start; ++p) {
                    if (lcp[p] < best) { best = lcp[p]; best_pos = p; }
                }
                idx->thresholds[k] = best_pos;
            }
            prev_run_of_char[c] = k;
            prev_end_of_char[c] = end;
        }
    }
    return idx;
}

extern "C" {

SpnIndex* spn_build(const u8* text, i64 text_len) {
    for (i64 i = 0; i < text_len; ++i)
        if (text[i] <= 1) return nullptr;  // 0/1 reserved (terminator coercion)
    // 32-bit index arithmetic halves construction memory (~13 B/char peak)
    // whenever the BWT fits in int32 — covers references to ~2 Gbp.
    if (text_len + 1 < (i64)INT32_MAX - 1)
        return spn_build_core<int32_t>(text, text_len);
    return spn_build_core<i64>(text, text_len);
}

i64 spn_num_runs(SpnIndex* idx) { return idx->r; }
i64 spn_bwt_len(SpnIndex* idx) { return idx->n; }

void spn_get_run_heads(SpnIndex* idx, u8* out) {
    std::memcpy(out, idx->run_heads.data(), idx->r);
}
void spn_get_run_starts(SpnIndex* idx, i64* out) {
    std::memcpy(out, idx->run_starts.data(), idx->r * sizeof(i64));
}
void spn_get_thresholds(SpnIndex* idx, i64* out) {
    std::memcpy(out, idx->thresholds.data(), idx->r * sizeof(i64));
}
void spn_get_samples_start(SpnIndex* idx, i64* out) {
    std::memcpy(out, idx->samples_start.data(), idx->r * sizeof(i64));
}
void spn_get_samples_last(SpnIndex* idx, i64* out) {
    std::memcpy(out, idx->samples_last.data(), idx->r * sizeof(i64));
}
void spn_free(SpnIndex* idx) { delete idx; }
void spn_get_lcp_dbg(SpnIndex* idx, i64* out) {
    std::memcpy(out, idx->lcp_dbg.data(), idx->lcp_dbg.size() * sizeof(i64));
}
i64 spn_lcp_dbg_len(SpnIndex* idx) { return (i64)idx->lcp_dbg.size(); }

}  // extern "C" (reopened below)

// ---------------------------------------------------------------------------
// Prefix-free parsing (functional equivalent of Big-BWT's newscan.x /
// pscan.x, invoked by the reference at /root/reference/src/spumoni.cpp:442-472
// with window w=10 and modulus hash_mod=100).
//
// A Karp-Rabin rolling hash over the last `w` characters marks a phrase
// boundary whenever hash % mod == 0; consecutive phrases OVERLAP by the
// w-character trigger window, so the parsing of T is prefix-free over the
// trigger-string set and T reconstructs as phrase_0 ++ phrase_1[w:] ++ ...
// The scanned string is Dollar(=2) ++ T ++ Dollar^w, mirroring the PFP
// special symbols of /root/reference/include/common.hpp:54-56 (Dollar=2,
// EndOfWord=1, EndOfDict=0 — text bytes must be >= 3 after remapping).
//
// This is the memory-lean front half of the large-reference build path: the
// parse (~n/avg_phrase ids) plus the dictionary (distinct phrases only) are
// the inputs to a PFP-based BWT/threshold induction that replaces in-memory
// SA-IS when the reference exceeds the SA-IS budget.
// ---------------------------------------------------------------------------

struct SpnParse {
    std::vector<u8>  dict_concat;  // phrases in lex order, 0x01 after each
    std::vector<i64> dict_off;     // [d] start offset of each phrase
    std::vector<i64> dict_len;     // [d] phrase length (without separator)
    std::vector<i64> occ;          // [d] occurrence count in the parse
    std::vector<i32> parse;        // [k] lex rank (1-based) of each phrase
};

static const u64 KR_PRIME = 1999999973ULL;  // Big-BWT's published KR modulus

// Single scan of the virtual string S = Dollar ++ text ++ Dollar^w: phrase
// boundaries at Karp-Rabin trigger windows; phrases/parse in first-seen order.
static void pfp_scan(const u8* text, i64 n, int w, int mod,
                     std::vector<std::string>& phrases,
                     std::vector<i32>& parse_tmp) {
    i64 ns = n + 1 + w;
    auto at = [&](i64 i) -> u8 {
        return (i == 0 || i > n) ? (u8)2 : text[i - 1];
    };
    // b^(w-1) mod q for removing the outgoing character
    u64 bw = 1;
    for (int i = 0; i < w - 1; ++i) bw = (bw * 256) % KR_PRIME;

    std::unordered_map<std::string, i32> ids;
    std::string cur;
    cur.push_back(at(0));
    u64 h = 0;
    auto close_phrase = [&]() {
        auto it = ids.find(cur);
        i32 id;
        if (it == ids.end()) {
            id = (i32)phrases.size();
            ids.emplace(cur, id);
            phrases.push_back(cur);
        } else {
            id = it->second;
        }
        parse_tmp.push_back(id);
    };
    for (i64 i = 1; i < ns; ++i) {
        u8 c = at(i);
        cur.push_back(c);
        if (i >= w) {
            if (i > w) {
                // remove char that left the window: S[i-w]
                u64 out = at(i - w);
                h = (h + KR_PRIME * 256 - out * bw % KR_PRIME) % KR_PRIME;
            }
            h = (h * 256 + c) % KR_PRIME;
            if (i == w) {
                // initialize full window hash
                h = 0;
                for (i64 j = i - w + 1; j <= i; ++j)
                    h = (h * 256 + at(j)) % KR_PRIME;
            }
            bool trigger = (h % (u64)mod == 0) && (i + w < ns);
            if (trigger || i == ns - 1) {
                close_phrase();
                if (i != ns - 1) {
                    // next phrase starts with the w-char trigger window
                    cur.assign(cur.end() - w, cur.end());
                }
            }
        }
    }
}

extern "C" {

SpnParse* spn_pfp_parse(const u8* text, i64 n, int w, int mod) {
    std::vector<std::string> phrases;          // in first-seen order
    std::vector<i32> parse_tmp;                // first-seen ids
    pfp_scan(text, n, w, mod, phrases, parse_tmp);

    // lex-sort the dictionary; remap parse ids to 1-based lex ranks
    SpnParse* p = new SpnParse();
    i64 d = (i64)phrases.size();
    std::vector<i32> order(d);
    for (i64 i = 0; i < d; ++i) order[i] = (i32)i;
    std::sort(order.begin(), order.end(), [&](i32 a, i32 b) {
        return phrases[a] < phrases[b];
    });
    std::vector<i32> rank(d);
    for (i64 i = 0; i < d; ++i) rank[order[i]] = (i32)i;

    p->dict_off.reserve(d);
    p->dict_len.reserve(d);
    p->occ.assign(d, 0);
    for (i64 i = 0; i < d; ++i) {
        const std::string& ph = phrases[order[i]];
        p->dict_off.push_back((i64)p->dict_concat.size());
        p->dict_len.push_back((i64)ph.size());
        p->dict_concat.insert(p->dict_concat.end(), ph.begin(), ph.end());
        p->dict_concat.push_back(1);  // EndOfWord (common.hpp:55)
    }
    p->dict_concat.push_back(0);      // EndOfDict (common.hpp:56)
    p->parse.reserve(parse_tmp.size());
    for (i32 id : parse_tmp) {
        i32 rk = rank[id];
        p->parse.push_back(rk + 1);   // 1-based like Big-BWT parses
        p->occ[rk]++;
    }
    return p;
}

i64 spn_parse_num_phrases(SpnParse* p) { return (i64)p->dict_off.size(); }
i64 spn_parse_len(SpnParse* p) { return (i64)p->parse.size(); }
i64 spn_parse_dict_bytes(SpnParse* p) { return (i64)p->dict_concat.size(); }
void spn_parse_get_dict(SpnParse* p, u8* out) {
    std::memcpy(out, p->dict_concat.data(), p->dict_concat.size());
}
void spn_parse_get_offsets(SpnParse* p, i64* off, i64* len, i64* occ) {
    std::memcpy(off, p->dict_off.data(), p->dict_off.size() * sizeof(i64));
    std::memcpy(len, p->dict_len.data(), p->dict_len.size() * sizeof(i64));
    std::memcpy(occ, p->occ.data(), p->occ.size() * sizeof(i64));
}
void spn_parse_get_parse(SpnParse* p, i32* out) {
    std::memcpy(out, p->parse.data(), p->parse.size() * sizeof(i32));
}
void spn_parse_free(SpnParse* p) { delete p; }

}  // extern "C" (reopened below)

// ---------------------------------------------------------------------------
// PFP-based index construction — the functional equivalent of pfp_thresholds
// (/root/reference/src/spumoni.cpp:524-545 runs it as a subprocess), built on
// the parser above. Produces RLBWT runs + thresholds + run-boundary SA
// samples IDENTICAL to spn_build()'s SA-IS path, in O(parse + dict) working
// memory instead of O(n) suffix-array memory — the route to references past
// the in-memory SA-IS budget (GRCh38 + revcomp scale).
//
// Theory (Boucher et al., "Prefix-free parsing for building big BWTs"):
//  * Every text suffix factors as (phrase suffix alpha, |alpha| > w) ++
//    (continuation C_{j+1} = body expansion of the following parse suffix),
//    where body = phrase[w:].
//  * The set of phrase suffixes of length > w is PREFIX-FREE (each contains
//    exactly one trigger occurrence, at its end), so text suffix order is:
//    alpha order first (from the dictionary's generalized SA), ties broken
//    by continuation order.
//  * Bodies are prefix-free too, so continuations compare exactly as parse
//    suffixes over body-deduplicated symbol ranks: the SA of the parse
//    (pfp_scan output) gives every tie-break rank (ISA_P[j+1]).
//  * LCPs stream along: between alpha-classes from the dictionary LCP;
//    within a class, |alpha| + (chars of the common phrase-prefix, via a
//    range-min over the parse LCP) + (body LCP of the first differing
//    phrases). Thresholds then fall out of per-character leftmost-argmin
//    trackers over the streamed LCP (same convention as spn_build).
// ---------------------------------------------------------------------------

namespace {

struct RMQ {  // sparse-table range minimum, O(1) query over [l, r] inclusive
    std::vector<std::vector<i64>> tbl;
    std::vector<i32> lg;
    void build(std::vector<i64> a) {
        i64 m = (i64)a.size();
        lg.assign(m + 1, 0);
        for (i64 i = 2; i <= m; ++i) lg[i] = lg[i / 2] + 1;
        tbl.assign(lg[m] + 1, {});
        tbl[0] = std::move(a);
        for (int j = 1; (1LL << j) <= m; ++j) {
            tbl[j].resize(m - (1LL << j) + 1);
            for (i64 i = 0; i + (1LL << j) <= m; ++i)
                tbl[j][i] = std::min(tbl[j - 1][i],
                                     tbl[j - 1][i + (1LL << (j - 1))]);
        }
    }
    i64 min(i64 l, i64 r) const {
        int j = lg[r - l + 1];
        return std::min(tbl[j][l], tbl[j][r - (1LL << j) + 1]);
    }
};

template <typename T>
void kasai_lcp(const T* s, const i64* sa, i64 m, std::vector<i64>& lcp) {
    lcp.assign(m, 0);
    std::vector<i64> rank(m);
    for (i64 i = 0; i < m; ++i) rank[sa[i]] = i;
    i64 h = 0;
    for (i64 i = 0; i < m; ++i) {
        if (rank[i] > 0) {
            i64 j = sa[rank[i] - 1];
            while (i + h < m && j + h < m && s[i + h] == s[j + h]) ++h;
            lcp[rank[i]] = h;
            if (h > 0) --h;
        } else {
            h = 0;
        }
    }
}

// Streaming run/threshold/sample accumulator: consumes (bwt char, SA value,
// LCP vs previous suffix) in lex order, reproducing spn_build's run loop and
// leftmost-argmin threshold convention exactly.
struct RunAccumulator {
    SpnIndex* idx;
    std::vector<i64>* lcp_dbg = nullptr;  // SPN_DEBUG_LCP: emitted LCP stream
    i64 ec = 0;          // emission counter = BWT position
    int last_char = -1;
    i64 last_end[256];
    i64 best_val[256], best_pos[256];
    bool has_closed[256];
    std::vector<u8> seen;  // chars with at least one closed run

    explicit RunAccumulator(SpnIndex* out) : idx(out) {
        for (int c = 0; c < 256; ++c) has_closed[c] = false;
    }
    void emit(u8 c, i64 sa, i64 lcp) {
        if (lcp_dbg) lcp_dbg->push_back(lcp);
        if (ec > 0) {
            if (c != (int)last_char) {
                // the last_char run closes at ec-1; its tracker restarts now
                if (!has_closed[last_char]) {
                    has_closed[last_char] = true;
                    seen.push_back((u8)last_char);
                }
                last_end[last_char] = ec - 1;
            }
            for (u8 cc : seen) {
                if (ec == last_end[cc] + 1) {
                    best_val[cc] = lcp; best_pos[cc] = ec;
                } else if (lcp < best_val[cc]) {
                    best_val[cc] = lcp; best_pos[cc] = ec;
                }
            }
        }
        if ((int)c != last_char) {
            idx->run_heads.push_back(c);
            idx->run_starts.push_back(ec);
            idx->samples_start.push_back(sa);
            idx->samples_last.push_back(sa);
            idx->thresholds.push_back(has_closed[c] ? best_pos[c] : 0);
        } else {
            idx->samples_last.back() = sa;
        }
        last_char = c;
        ++ec;
    }
};

}  // namespace

// Worker-local accumulator for the PARALLEL class sweep: reproduces
// RunAccumulator's per-emission state machine over one dict-SA segment and
// exports exactly the data seam-stitching needs:
//   * first_lcp — the lcp it assigned to its local emission 0; the stitcher
//     min-folds the cross-seam carry into it (every cross-seam LCP effect
//     reaches the stream through that single value);
//   * per-char head snapshots — leftmost-argmin of the local lcp stream over
//     [1 .. first local c-run start], so the threshold of each char's FIRST
//     local run (whose window begins at the previous GLOBAL c-run end) can
//     be recomposed;
//   * per-char tail trackers (the plain RunAccumulator trackers at stream
//     end) and a whole-stream tracker for chars with no local runs;
//   * pending/empty-carry end state — the sequential machine's chain value
//     entering the next segment.
struct LocalAcc {
    std::vector<u8>  heads;
    std::vector<i64> starts, ssamp, esamp, thr;
    i64 ec = 0;
    int last_char = -1;
    i64 last_end[256];
    i64 best_val[256], best_pos[256];
    bool has_closed[256];
    std::vector<u8> seen;
    static constexpr i64 INF = (i64)1 << 62;
    // whole-stream leftmost-min over local emissions >= 1
    i64 all_val = INF, all_pos = -1;
    // snapshot of (all_val, all_pos) when each char's FIRST local run opens
    i64 head_val[256], head_pos[256];
    bool has_head[256];
    i64 first_lcp = -1;
    // class-loop chain state at segment end (filled by the sweep loop)
    i64 pending_end = INF, empty_carry_end = INF;

    LocalAcc() {
        for (int c = 0; c < 256; ++c) {
            has_closed[c] = false;
            has_head[c] = false;
        }
    }
    void emit(u8 c, i64 sa, i64 lcp) {
        if (ec == 0) first_lcp = lcp;
        if (ec > 0) {
            if (lcp < all_val) { all_val = lcp; all_pos = ec; }
            if (c != (int)last_char) {
                if (!has_closed[last_char]) {
                    has_closed[last_char] = true;
                    seen.push_back((u8)last_char);
                }
                last_end[last_char] = ec - 1;
            }
            for (u8 cc : seen) {
                if (ec == last_end[cc] + 1) {
                    best_val[cc] = lcp; best_pos[cc] = ec;
                } else if (lcp < best_val[cc]) {
                    best_val[cc] = lcp; best_pos[cc] = ec;
                }
            }
        }
        if ((int)c != last_char) {
            if (!has_head[c]) {
                has_head[c] = true;
                head_val[c] = all_val;
                head_pos[c] = all_pos;
            }
            heads.push_back(c);
            starts.push_back(ec);
            ssamp.push_back(sa);
            esamp.push_back(sa);
            thr.push_back(has_closed[c] ? best_pos[c] : 0);
        } else {
            esamp.back() = sa;
        }
        last_char = c;
        ++ec;
    }
};

static SpnIndex* spn_build_pfp_core(const u8* text, i64 n_text, int w,
                                    int mod, int threads) {
    const bool dbg_t = std::getenv("SPN_DEBUG_TIME") != nullptr;
    auto now = []() {
        return std::chrono::duration<double>(
            std::chrono::steady_clock::now().time_since_epoch()).count();
    };
    double t0 = now();
    auto phase = [&](const char* name) {
        if (dbg_t) {
            double t = now();
            fprintf(stderr, "[pfp] %-12s %.2fs\n", name, t - t0);
            t0 = t;
        }
    };
    std::vector<std::string> phrases;  // first-seen order
    std::vector<i32> parse;            // [k] first-seen ids
    pfp_scan(text, n_text, w, mod, phrases, parse);
    phase("scan");
    const i64 d = (i64)phrases.size();
    const i64 k = (i64)parse.size();

    // generalized SA over the dictionary (phrases ++ 0x01, final 0x00) —
    // independent of the parse-side structures, so it runs CONCURRENTLY
    // with them when threads allow (the reference's analog is pscan.x -t /
    // OpenMP in its builders, /root/reference/src/spumoni.cpp:445-455)
    std::vector<u8> D;
    std::vector<i64> dstart(d);
    std::vector<i32> downer;
    std::vector<i64> SAD, LCPD;
    auto build_dict_sa = [&]() {
        for (i64 i = 0; i < d; ++i) {
            dstart[i] = (i64)D.size();
            D.insert(D.end(), phrases[i].begin(), phrases[i].end());
            D.push_back(1);
            downer.resize(D.size(), (i32)i);
        }
        D.push_back(0);
        downer.push_back(-1);
        SAD.resize((i64)D.size());
        sais_rec<u8, i64>(D.data(), SAD.data(), (i64)D.size(), 256);
        kasai_lcp<u8>(D.data(), SAD.data(), (i64)D.size(), LCPD);
    };
    std::thread dict_thread;
    if (threads > 1) dict_thread = std::thread(build_dict_sa);

    // body ranks, DEDUPLICATED: equal bodies (same phrase minus its leading
    // trigger) must get EQUAL parse symbols or continuation comparisons break
    std::vector<i32> by_body(d);
    for (i64 i = 0; i < d; ++i) by_body[i] = (i32)i;
    auto body_of = [&](i32 id) {
        return std::string_view(phrases[id]).substr((size_t)w);
    };
    std::sort(by_body.begin(), by_body.end(), [&](i32 a, i32 b) {
        return body_of(a) < body_of(b);
    });
    std::vector<i64> brank(d);          // first-seen id -> dedup body rank
    std::vector<i32> body_rep;          // body rank -> representative id
    for (i64 i = 0; i < d; ++i) {
        if (i == 0 || body_of(by_body[i]) != body_of(by_body[i - 1]))
            body_rep.push_back(by_body[i]);
        brank[by_body[i]] = (i64)body_rep.size() - 1;
    }
    const i64 du = (i64)body_rep.size();

    // parse over body symbols, 1-based, 0-terminated; SA/ISA/LCP of it
    std::vector<i64> P(k + 1);
    for (i64 j = 0; j < k; ++j) P[j] = brank[parse[j]] + 1;
    P[k] = 0;
    std::vector<i64> SAP(k + 1), ISAP(k + 1), LCPP;
    sais_rec<i64, i64>(P.data(), SAP.data(), k + 1, du + 2);
    for (i64 t = 0; t <= k; ++t) ISAP[SAP[t]] = t;
    kasai_lcp<i64>(P.data(), SAP.data(), k + 1, LCPP);
    RMQ rmq_p; rmq_p.build(LCPP);
    phase("parse-sa");

    // S-position of each phrase occurrence start; s[k]+w == |S|
    std::vector<i64> s(k + 1);
    s[0] = 0;
    for (i64 j = 0; j < k; ++j)
        s[j + 1] = s[j] + (i64)phrases[parse[j]].size() - w;

    // body LCP between adjacent UNIQUE bodies + RMQ -> bodyLCP(rank x, rank y)
    std::vector<i64> LCPB(du, 0);
    for (i64 i = 1; i < du; ++i) {
        auto a = body_of(body_rep[i - 1]), b = body_of(body_rep[i]);
        size_t h = 0, m = std::min(a.size(), b.size());
        while (h < m && a[h] == b[h]) ++h;
        LCPB[i] = (i64)h;
    }
    RMQ rmq_b; rmq_b.build(LCPB);
    auto body_lcp = [&](i64 px, i64 py) -> i64 {  // px, py are P[] symbols
        if (px == 0 || py == 0) return 0;
        if (px == py) return (i64)body_of(body_rep[px - 1]).size();
        i64 lo = std::min(px, py), hi = std::max(px, py);
        return rmq_b.min(lo, hi - 1);  // LCPB[i] = lcp(body i-1, body i)
    };

    // char-level LCP of the continuations of parse suffixes m1, m2 whose
    // ISA ranks are t1 < t2 (continuation of occurrence j = parse suffix j+1)
    auto cont_lcp = [&](i64 t1, i64 t2) -> i64 {
        i64 lp = rmq_p.min(t1 + 1, t2);            // common phrases
        i64 m1 = SAP[t1], m2 = SAP[t2];
        i64 chars = s[m1 + lp] - s[m1];
        if (m1 + lp <= k && m2 + lp <= k)
            chars += body_lcp(P[m1 + lp], P[m2 + lp]);
        return chars;
    };

    // occurrence lists per phrase, ordered by continuation rank ISA_P[j+1]:
    // scan SA_P; parse suffix m >= 1 is the continuation of occurrence m-1
    std::vector<i64> ilist_off(d + 1, 0), ilist(k);
    {
        std::vector<i64> cnt(d, 0);
        for (i64 j = 0; j < k; ++j) cnt[parse[j]]++;
        for (i64 i = 0; i < d; ++i) ilist_off[i + 1] = ilist_off[i] + cnt[i];
        std::vector<i64> fill = ilist_off;
        for (i64 t = 0; t <= k; ++t) {
            i64 m = SAP[t];
            if (m >= 1) ilist[fill[parse[m - 1]]++] = m - 1;
        }
    }

    if (dict_thread.joinable()) dict_thread.join();
    else build_dict_sa();
    const i64 nd = (i64)D.size();
    phase("dict-sa");

    SpnIndex* idx = new SpnIndex();
    idx->n = n_text + 1;
    auto coerce = [](u8 c) -> u8 { return c <= 2 ? (u8)1 : c; };
    struct Member { i32 a; i64 o; };
    const i64 INF = (i64)1 << 62;

    // one dict-SA segment of the alpha-class sweep, emitting into `emit`
    // and reporting the chain state at segment end. Segments always begin
    // at a position with LCPD[t] <= w, which forces a new class at the
    // first accepted suffix regardless of upstream state (class membership
    // requires pending >= l > w).
    auto sweep_segment = [&](i64 tb, i64 te,
                             const std::function<void(u8, i64, i64)>& emit,
                             i64 pending0, i64* pending_out,
                             i64* empty_carry_out) {
        std::vector<Member> members;
        i64 cls_len = -1;
        i64 pending = pending0;
        i64 boundary = 0;
        i64 empty_carry = INF;
        i64 prev_rank = -1;
        std::vector<i64> ptr_s, end_s;
        auto flush = [&]() {
            if (members.empty()) return;
            size_t nm = members.size();
            ptr_s.resize(nm); end_s.resize(nm);
            i64* ptr = ptr_s.data(); i64* end = end_s.data();
            for (size_t x = 0; x < nm; ++x) {
                ptr[x] = ilist_off[members[x].a];
                end[x] = ilist_off[members[x].a + 1];
            }
            bool first = true;
            while (true) {
                int best = -1;
                if (nm == 1) {
                    if (ptr[0] < end[0]) best = 0;
                } else {
                    i64 best_rank = 0;
                    for (size_t x = 0; x < nm; ++x) {
                        if (ptr[x] < end[x]) {
                            i64 j = ilist[ptr[x]];
                            i64 rk = ISAP[j + 1];
                            if (best < 0 || rk < best_rank) {
                                best = (int)x; best_rank = rk;
                            }
                        }
                    }
                }
                if (best < 0) break;
                i64 j = ilist[ptr[best]++];
                const Member& mb = members[best];
                i64 i_S = s[j] + mb.o;
                if (i_S == 0) continue;  // leading-Dollar: not a T suffix
                u8 ch;
                if (mb.o > 0) {
                    ch = (u8)phrases[mb.a][mb.o - 1];
                } else {
                    const std::string& pv = phrases[parse[j - 1]];
                    ch = (u8)pv[pv.size() - w - 1];
                }
                i64 lcp;
                if (first) {
                    lcp = boundary;
                } else {
                    lcp = cls_len + cont_lcp(prev_rank, ISAP[j + 1]);
                }
                emit(coerce(ch), i_S - 1, lcp);
                prev_rank = ISAP[j + 1];
                first = false;
            }
            if (first && !members.empty()) {
                // class emitted nothing: its boundary joins the LCP
                // min-chain between the surrounding emitting classes
                empty_carry = std::min(empty_carry, boundary);
            } else if (!first) {
                empty_carry = INF;
            }
            members.clear();
        };
        for (i64 t = tb; t < te; ++t) {
            pending = std::min(pending, LCPD[t]);
            i64 q = SAD[t];
            i32 a = downer[q];
            if (a < 0) continue;
            i64 o = q - dstart[a];
            i64 plen = (i64)phrases[a].size();
            if (o >= plen) continue;      // separator position
            i64 l = plen - o;
            if (l <= w) continue;         // shorter than a trigger: skip
            bool same = !members.empty() && l == cls_len && pending >= l;
            if (!same) {
                i64 b = pending;
                flush();  // may set empty_carry from the closed class
                boundary = std::min(std::min(b, empty_carry), l);
                cls_len = l;
            }
            members.push_back({a, o});
            pending = INF;  // measure the next LCP gap from this suffix
        }
        flush();
        *pending_out = pending;
        *empty_carry_out = empty_carry;
    };

    // the terminator suffix of T ++ [0]: BWT char = last char of T
    const std::string& last_ph = phrases[parse[k - 1]];
    const u8 term_prev = coerce((u8)last_ph[last_ph.size() - w - 1]);

    i64 segs = threads;
    if (const char* env = std::getenv("SPN_SWEEP_SEGMENTS"))
        segs = std::max((i64)1, (i64)atoll(env));

    if (segs <= 1) {
        // sequential path (also the oracle the segmented path must match)
        RunAccumulator acc(idx);
        if (std::getenv("SPN_DEBUG_LCP")) acc.lcp_dbg = &idx->lcp_dbg;
        acc.emit(term_prev, n_text, 0);
        i64 pe, ee;
        sweep_segment(1, nd, [&](u8 c, i64 sa, i64 lcp) {
            acc.emit(c, sa, lcp);
        }, /*pending0=*/0, &pe, &ee);
        phase("sweep");
        idx->r = (i64)idx->run_heads.size();
        if (acc.ec != idx->n) { delete idx; return nullptr; }
        return idx;
    }

    // ---- segmented (threaded) sweep + seam stitching ----
    // segment starts must satisfy LCPD[t] <= w (guaranteed class boundary)
    std::vector<i64> cut{1};
    for (i64 p = 1; p < segs; ++p) {
        i64 t0 = 1 + (nd - 1) * p / segs;
        while (t0 < nd && LCPD[t0] > w) ++t0;
        if (t0 > cut.back() && t0 < nd) cut.push_back(t0);
    }
    cut.push_back(nd);
    const size_t ns = cut.size() - 1;

    std::vector<LocalAcc> accs(ns);
    {
        std::vector<std::thread> pool;
        std::atomic<size_t> next{0};
        int nt = std::max(1, std::min((int)ns, threads));
        auto work = [&]() {
            size_t p;
            while ((p = next.fetch_add(1)) < ns) {
                LocalAcc& A = accs[p];
                sweep_segment(cut[p], cut[p + 1],
                              [&A](u8 c, i64 sa, i64 lcp) {
                                  A.emit(c, sa, lcp);
                              },
                              LocalAcc::INF, &A.pending_end,
                              &A.empty_carry_end);
            }
        };
        for (int x = 1; x < nt; ++x) pool.emplace_back(work);
        work();
        for (auto& th : pool) th.join();
    }

    // stitch: replay the cross-seam effects. The terminator emission is
    // global emission 0; worker 0's carry is the sequential pending0 = 0.
    idx->run_heads.push_back(term_prev);
    idx->run_starts.push_back(0);
    idx->samples_start.push_back(n_text);
    idx->samples_last.push_back(n_text);
    idx->thresholds.push_back(0);
    i64 g_last_end[256], g_best_val[256], g_best_pos[256];
    bool g_closed[256];
    for (int c = 0; c < 256; ++c) g_closed[c] = false;
    std::vector<u8> g_seen;
    i64 ec = 1;
    int last_char = term_prev;
    i64 carry = 0;
    for (size_t p = 0; p < ns; ++p) {
        LocalAcc& A = accs[p];
        if (A.ec == 0) {
            carry = std::min({carry, A.pending_end, A.empty_carry_end});
            continue;
        }
        const i64 seam = std::min(A.first_lcp, carry);
        const i64 base = ec;
        const u8 c0 = A.heads[0];
        const bool merge = ((int)c0 == last_char);
        // seam emission replay for the global trackers (emit()'s ec>0 path)
        if (!merge) {
            if (!g_closed[last_char]) {
                g_closed[last_char] = true;
                g_seen.push_back((u8)last_char);
            }
            g_last_end[last_char] = base - 1;
        }
        for (u8 cc : g_seen) {
            if (base == g_last_end[cc] + 1) {
                g_best_val[cc] = seam; g_best_pos[cc] = base;
            } else if (seam < g_best_val[cc]) {
                g_best_val[cc] = seam; g_best_pos[cc] = base;
            }
        }
        // append runs; recompose each char's FIRST local run's threshold
        bool first_done[256] = {false};
        for (size_t j = 0; j < A.heads.size(); ++j) {
            u8 c = A.heads[j];
            bool is_first_local = !first_done[c];
            first_done[c] = true;
            if (j == 0 && merge) {
                idx->samples_last.back() = A.esamp[0];
                continue;
            }
            // local thresholds are local emission indices; only a char's
            // first local run needs global recomposition
            i64 tval = base + A.thr[j];
            if (is_first_local) {
                if (g_closed[c]) {
                    i64 v = g_best_val[c], pos = g_best_pos[c];
                    if (A.has_head[c] && A.head_pos[c] >= 0
                            && A.head_val[c] < v) {
                        v = A.head_val[c];
                        pos = base + A.head_pos[c];
                    }
                    tval = pos;
                } else {
                    tval = 0;  // globally-first run of c
                }
            }
            idx->run_heads.push_back(c);
            idx->run_starts.push_back(base + A.starts[j]);
            idx->samples_start.push_back(A.ssamp[j]);
            idx->samples_last.push_back(A.esamp[j]);
            idx->thresholds.push_back(tval);
        }
        // advance the global trackers to end-of-segment state
        for (u8 c : A.seen) {  // chars with a locally-CLOSED run
            if (!g_closed[c]) { g_closed[c] = true; g_seen.push_back(c); }
            g_last_end[c] = base + A.last_end[c];
            g_best_val[c] = A.best_val[c];
            g_best_pos[c] = base + A.best_pos[c];
        }
        for (u8 cc : g_seen) {  // others: fold the whole-stream tracker
            if (A.has_closed[cc]) continue;
            if (A.all_pos >= 0 && A.all_val < g_best_val[cc]) {
                g_best_val[cc] = A.all_val;
                g_best_pos[cc] = base + A.all_pos;
            }
        }
        last_char = A.heads.back();
        ec = base + A.ec;
        carry = std::min(A.pending_end, A.empty_carry_end);
    }
    phase("sweep");
    idx->r = (i64)idx->run_heads.size();
    if (ec != idx->n) { delete idx; return nullptr; }  // coverage check
    return idx;
}

extern "C" {

// PFP-based build (pfp_thresholds equivalent): same outputs as spn_build,
// O(parse + dict) working memory. Text bytes must be >= 3 (0/1/2 are the
// PFP specials EndOfDict/EndOfWord/Dollar, common.hpp:54-56).
// `threads` > 1 additionally (a) overlaps the dictionary-SA construction
// with the parse-side structures and (b) partitions the alpha-class sweep
// over dict-SA segments with exact seam stitching — the counterpart of the
// reference's pscan.x -t / OpenMP build parallelism (spumoni.cpp:445-455,
// doc_array.cpp:56). Output is byte-identical at any thread count.
SpnIndex* spn_build_pfp_mt(const u8* text, i64 text_len, int w, int mod,
                           int threads) {
    if (text_len <= w) return nullptr;
    for (i64 i = 0; i < text_len; ++i)
        if (text[i] <= 2) return nullptr;
    return spn_build_pfp_core(text, text_len, w, mod,
                              threads < 1 ? 1 : threads);
}

SpnIndex* spn_build_pfp(const u8* text, i64 text_len, int w, int mod) {
    return spn_build_pfp_mt(text, text_len, w, mod, 1);
}

}  // extern "C" (reopened below)

extern "C" {

// ---------------------------------------------------------------------------
// CPU query engine over dense per-character run tables.
//
// Implements pml_pointers::_query (compute_ms_pml.cpp:237-286) and
// ms_pointers::_query (:570-623) plus the ms_t extension loop (:802-810),
// with bwt.rank/select/run_of_position realized as one binary search per step
// over the runs of the query character.
// ---------------------------------------------------------------------------

struct SpnQuery {
    i64 n = 0;            // BWT length
    i64 r = 0;
    i64 F[256];           // F[c] = # of BWT chars < c
    i64 cnt[256];         // number_of_letter(c)
    i64 char_off[257];    // per-char slice of the run tables below
    std::vector<i64> c_start;   // [r] run start position (grouped by char, sorted)
    std::vector<i64> c_len;     // [r] run length
    std::vector<i64> c_cum;     // [r] # of char occurrences in earlier runs of same char
    std::vector<i64> c_thr;     // [r] absolute threshold of this run
    std::vector<i64> c_ssamp;   // [r] (SA[run_start]-1) mod n   ("samples_start")
    std::vector<i64> c_esamp;   // [r] (SA[run_end]-1) mod n     ("samples_last")
    std::vector<i64> c_sdoc;    // [r] doc id of run-start sample (optional)
    std::vector<i64> c_edoc;    // [r] doc id of run-end sample (optional)
    bool has_doc = false;
    i64 last_run_sample = 0;    // SA[n-1] (seed for the MS recurrence)
    i64 last_run_edoc = 0;      // end_runs_doc of the last run
    i64 first_run_sdoc = 0;     // start_runs_doc of run 0 (cnt[c]==0 fallback)
    std::vector<u8> text;       // indexed text (for MS extension)
};

// Builds a query engine from builder outputs. samples are RAW SA values here;
// the (sa-1) mod n conversion is applied internally. doc arrays may be null.
SpnQuery* spn_query_new(i64 n, i64 r, const u8* run_heads, const i64* run_starts,
                        const i64* thresholds, const i64* samples_start,
                        const i64* samples_last, const i64* start_doc,
                        const i64* end_doc, const u8* text, i64 text_len) {
    SpnQuery* q = new SpnQuery();
    q->n = n;
    q->r = r;
    if (text && text_len > 0) q->text.assign(text, text + text_len);

    std::vector<i64> run_len(r);
    for (i64 k = 0; k < r; ++k)
        run_len[k] = ((k + 1 < r) ? run_starts[k + 1] : n) - run_starts[k];

    i64 count[256] = {0};
    i64 runs_of_char[256] = {0};
    for (i64 k = 0; k < r; ++k) {
        count[run_heads[k]] += run_len[k];
        runs_of_char[run_heads[k]]++;
    }
    for (int c = 0; c < 256; ++c) q->cnt[c] = count[c];
    i64 acc = 0;
    for (int c = 0; c < 256; ++c) { q->F[c] = acc; acc += count[c]; }

    q->char_off[0] = 0;
    for (int c = 0; c < 256; ++c)
        q->char_off[c + 1] = q->char_off[c] + runs_of_char[c];

    q->c_start.resize(r); q->c_len.resize(r); q->c_cum.resize(r); q->c_thr.resize(r);
    q->c_ssamp.resize(r); q->c_esamp.resize(r);
    q->has_doc = (start_doc != nullptr && end_doc != nullptr);
    if (q->has_doc) { q->c_sdoc.resize(r); q->c_edoc.resize(r); }

    i64 fill[256];
    i64 cum[256] = {0};
    for (int c = 0; c < 256; ++c) fill[c] = q->char_off[c];
    for (i64 k = 0; k < r; ++k) {
        u8 c = run_heads[k];
        i64 idx = fill[c]++;
        q->c_start[idx] = run_starts[k];
        q->c_len[idx] = run_len[k];
        q->c_cum[idx] = cum[c];
        cum[c] += run_len[k];
        q->c_thr[idx] = thresholds[k];
        q->c_ssamp[idx] = (samples_start[k] > 0) ? samples_start[k] - 1 : n - 1;
        q->c_esamp[idx] = (samples_last[k] > 0) ? samples_last[k] - 1 : n - 1;
        if (q->has_doc) { q->c_sdoc[idx] = start_doc[k]; q->c_edoc[idx] = end_doc[k]; }
    }
    q->last_run_sample = samples_last[r - 1];  // raw SA[n-1]
    if (q->has_doc) {
        q->last_run_edoc = end_doc[r - 1];
        q->first_run_sdoc = start_doc[0];
    }
    return q;
}

void spn_query_free(SpnQuery* q) { delete q; }

namespace {

// One PML query (compute_ms_pml.cpp:237-286). out_docs may be null.
void query_pml_one(const SpnQuery* q, const u8* read, i64 m, i64* out,
                   i64* out_docs) {
    i64 pos = q->n - 1;
    i64 length = 0;
    i64 doc = q->last_run_edoc;
    for (i64 i = m - 1; i >= 0; --i) {
        u8 c = read[i];
        if (q->cnt[c] == 0) {
            // compute_ms_pml.cpp:303 — the PML doc variant keeps the previous
            // doc id here, so only (length, pos) change.
            length = 0;
            pos = q->F[c];
        } else {
            i64 lo = q->char_off[c], hi = q->char_off[c + 1];
            // k = last run of c with start <= pos (or lo-1)
            i64 k = std::upper_bound(q->c_start.data() + lo, q->c_start.data() + hi,
                                     pos) - q->c_start.data() - 1;
            if (k >= lo && pos < q->c_start[k] + q->c_len[k]) {
                // bwt[pos] == c : extend
                ++length;
                pos = q->F[c] + q->c_cum[k] + (pos - q->c_start[k]);
            } else {
                i64 rnk = (k >= lo) ? q->c_cum[k] + q->c_len[k] : 0;
                length = 0;
                bool jump_down = false;
                if (k + 1 < hi) {  // rnk < cnt[c]: a next run of c exists
                    i64 thr = q->c_thr[k + 1];
                    if (pos >= thr) {
                        jump_down = true;
                        if (out_docs) doc = q->c_sdoc[k + 1];
                    }
                }
                if (jump_down) {
                    pos = q->F[c] + rnk;
                } else {
                    if (out_docs) doc = q->c_edoc[k];
                    pos = q->F[c] + rnk - 1;
                }
            }
        }
        out[i] = length;
        if (out_docs) out_docs[i] = doc;
    }
}

// One MS-pointer query (compute_ms_pml.cpp:570-623).
void query_ms_one(const SpnQuery* q, const u8* read, i64 m, i64* out_ptrs,
                  i64* out_docs) {
    i64 pos = q->n - 1;
    i64 sample = q->last_run_sample;  // SA[n-1]
    i64 doc = q->last_run_edoc;
    for (i64 i = m - 1; i >= 0; --i) {
        u8 c = read[i];
        if (q->cnt[c] == 0) {
            // compute_ms_pml.cpp:639-643: doc <- start_runs_doc[run_of(0)],
            // i.e. the start doc of run 0.
            sample = 0;
            pos = q->F[c];
            if (out_docs) doc = q->first_run_sdoc;
        } else {
            i64 lo = q->char_off[c], hi = q->char_off[c + 1];
            i64 k = std::upper_bound(q->c_start.data() + lo, q->c_start.data() + hi,
                                     pos) - q->c_start.data() - 1;
            if (k >= lo && pos < q->c_start[k] + q->c_len[k]) {
                // Note: after a cnt==0 reset the reference's unsigned sample--
                // underflows to 2^64-1, 2^64-2, ... (compute_ms_pml.cpp:582).
                // We carry the equivalent negative values; the extension below
                // treats them as out-of-bounds exactly like the huge unsigned
                // values, and the CLI prints them as unsigned 64-bit for
                // byte parity.
                --sample;
                pos = q->F[c] + q->c_cum[k] + (pos - q->c_start[k]);
            } else {
                i64 rnk = (k >= lo) ? q->c_cum[k] + q->c_len[k] : 0;
                bool jump_down = false;
                if (k + 1 < hi) {
                    i64 thr = q->c_thr[k + 1];
                    if (pos >= thr) {
                        jump_down = true;
                        sample = q->c_ssamp[k + 1];
                        if (out_docs) doc = q->c_sdoc[k + 1];
                    }
                }
                if (jump_down) {
                    pos = q->F[c] + rnk;
                } else {
                    sample = q->c_esamp[k];
                    if (out_docs) doc = q->c_edoc[k];
                    pos = q->F[c] + rnk - 1;
                }
            }
        }
        out_ptrs[i] = sample;
        if (out_docs) out_docs[i] = doc;
    }
}

// MS extension: pointers -> lengths via text comparison (compute_ms_pml.cpp:802-810).
void extend_ms_one(const SpnQuery* q, const u8* read, i64 m, const i64* ptrs,
                   i64* out_lens) {
    i64 tlen = (i64)q->text.size();
    i64 l = 0;
    for (i64 i = 0; i < m; ++i) {
        i64 pos = ptrs[i];
        while (i + l < m && pos >= 0 && pos + l < tlen &&
               (i < 1 || pos != ptrs[i - 1] + 1) &&
               read[i + l] == q->text[pos + l])
            ++l;
        out_lens[i] = l;
        l = (l == 0) ? 0 : l - 1;
    }
}

void parallel_over_reads(i64 nreads, int threads,
                         const std::function<void(i64)>& fn) {
    if (threads <= 1) {
        for (i64 i = 0; i < nreads; ++i) fn(i);
        return;
    }
    std::atomic<i64> next(0);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
        pool.emplace_back([&]() {
            for (;;) {
                i64 i = next.fetch_add(1);
                if (i >= nreads) break;
                fn(i);
            }
        });
    for (auto& th : pool) th.join();
}

}  // namespace

// Batched queries. reads = concatenated bytes; offsets has nreads+1 entries.
// Outputs are written at the same offsets. out_docs may be null.
void spn_query_pml_batch(SpnQuery* q, const u8* reads, const i64* offsets,
                         i64 nreads, i64* out, i64* out_docs, int threads) {
    parallel_over_reads(nreads, threads, [&](i64 i) {
        i64 b = offsets[i], e = offsets[i + 1];
        query_pml_one(q, reads + b, e - b, out + b,
                      out_docs ? out_docs + b : nullptr);
    });
}

void spn_query_ms_batch(SpnQuery* q, const u8* reads, const i64* offsets,
                        i64 nreads, i64* out_ptrs, i64* out_lens, i64* out_docs,
                        int threads) {
    parallel_over_reads(nreads, threads, [&](i64 i) {
        i64 b = offsets[i], e = offsets[i + 1];
        query_ms_one(q, reads + b, e - b, out_ptrs + b,
                     out_docs ? out_docs + b : nullptr);
        if (out_lens)
            extend_ms_one(q, reads + b, e - b, out_ptrs + b, out_lens + b);
    });
}

// Decimal text formatting for the value output files — the role iostream
// formatting plays in the reference's writer loops
// (compute_ms_pml.cpp:1001-1021): each value printed as unsigned 64-bit
// (negative inputs reproduce the reference's size_t underflow,
// compute_ms_pml.cpp:582) followed by one space. Returns bytes written;
// `out` must hold >= 21 * n bytes.
i64 spn_format_values(const i64* v, i64 n, char* out) {
    char* p = out;
    char tmp[24];
    for (i64 i = 0; i < n; ++i) {
        u64 x = (u64)v[i];
        int t = 0;
        do { tmp[t++] = (char)('0' + (x % 10)); x /= 10; } while (x);
        while (t) *p++ = tmp[--t];
        *p++ = ' ';
    }
    return (i64)(p - out);
}

// ---------------------------------------------------------------------------
// Streaming-side prep: FASTA/FASTQ chunk extraction + lockstep row packing.
// The host feed of the production run (the reference's BatchLoader +
// per-read toupper loop, batch_loader.cpp:26-76 / compute_ms_pml.cpp:917) —
// one C pass per chunk instead of ~10 numpy passes (the host prep capped
// file->report throughput; see PERF_NOTES round 4).
// ---------------------------------------------------------------------------

// Parses one chunk of COMPLETE newline-terminated records. Outputs:
//   seq     concatenated UPPER-CASED sequence bytes (caller: >= n bytes)
//   offs    per-read seq offsets, offs[0] = 0 (caller: >= n/4 + 2 entries)
//   idpos   (start, end) byte ranges of each read id inside `data`, with
//           BatchLoader's exact id semantics incl. the off-by-one keeping
//           ONE delimiter char (batch_loader.cpp:104-106)
// Returns the number of reads, or -1 on malformed input.
i64 spn_fastx_extract(const u8* data, i64 n, int fastq, int do_upper,
                      u8* seq, i64* offs, i64* idpos) {
    u8 tab[256];
    for (int i = 0; i < 256; ++i)
        tab[i] = (u8)((do_upper && i >= 'a' && i <= 'z') ? i - 32 : i);
    i64 nr = 0, so = 0, i = 0;
    offs[0] = 0;
    auto id_range = [&](i64 hstart, i64 hend) {
        // line = marker + header; first of " \t\r" at j >= 1 keeps one char
        i64 a = hstart, e = hend;
        i64 j = e;
        for (i64 k = a; k < e; ++k) {
            u8 c = data[k];
            if (c == ' ' || c == '\t' || c == '\r') { j = k + 1; break; }
        }
        idpos[2 * nr] = a;
        idpos[2 * nr + 1] = j < e ? j : e;
    };
    if (fastq) {
        while (i < n) {
            if (data[i] == '\n') { ++i; continue; }   // defensive blank lines
            if (data[i] == '\r' && i + 1 < n && data[i + 1] == '\n') {
                i += 2; continue;                     // '\r\n' blank line
            }
            if (data[i] != '@') return -1;
            i64 hs = i + 1;
            while (i < n && data[i] != '\n') ++i;
            i64 he = i; if (he > hs && data[he - 1] == '\r') --he;
            id_range(hs, he);
            ++i;                                      // sequence line
            offs[nr + 1] = offs[nr];
            while (i < n && data[i] != '\n') {
                u8 c = data[i++];
                if (c != '\r') { seq[so++] = tab[c]; ++offs[nr + 1]; }
            }
            ++i;
            if (i >= n || data[i] != '+') return -1;  // '+' line
            while (i < n && data[i] != '\n') ++i;
            ++i;                                      // quality line
            while (i < n && data[i] != '\n') ++i;
            ++i;
            ++nr;
        }
        return nr;
    }
    while (i < n) {
        if (data[i] == '\n') { ++i; continue; }
        if (data[i] == '\r' && i + 1 < n && data[i + 1] == '\n') {
            i += 2; continue;                         // '\r\n' blank line
        }
        if (data[i] != '>') return -1;
        i64 hs = i + 1;
        while (i < n && data[i] != '\n') ++i;
        i64 he = i; if (he > hs && data[he - 1] == '\r') --he;
        id_range(hs, he);
        ++i;
        offs[nr + 1] = offs[nr];
        while (i < n && data[i] != '>') {             // multi-line sequence
            u8 c = data[i++];
            if (c != '\n' && c != '\r') { seq[so++] = tab[c]; ++offs[nr + 1]; }
        }
        ++nr;
    }
    return nr;
}

// Packs selected CSR reads into [B, L] lockstep rows: optional reversal
// (folded into the copy direction), byte->value mapping via `amap` (256
// entries; 255 = uncovered byte), and bit-width packing:
//   bits=8  [B, L]   one value per byte
//   bits=4  [B, L/2] nibble-packed (values < 16)
//   bits=2  [B, L/4] 2-bit codes from `amap2` (byte -> 0..3; 255 = not
//           2-bit-codable). Non-codable positions are emitted as
//           (row, col, amap[byte]) exception triples into `exc` — the
//           device scatters them over the unpacked base codes. Rare by
//           construction (N bases); returns -1 if they exceed exc_cap.
// Rows past nsel stay zero (caller zeroes `out`). Returns the exception
// count (0 for bits 8/4), -1 on exception overflow, -2 if any byte mapped
// to amap sentinel 255 (caller extends the alphabet and retries).
i64 spn_pack_rows(const u8* buf, const i64* starts, const i64* ends,
                  i64 nsel, i64 L, const u8* amap, int reverse, int bits,
                  u8* out, const u8* amap2, i32* exc, i64 exc_cap,
                  int threads) {
    std::atomic<int> miss{0};
    std::atomic<i64> nexc{0};
    i64 rowbytes = bits == 2 ? L / 4 : bits == 4 ? L / 2 : L;
    auto work = [&](i64 lo, i64 hi) {
        int local_miss = 0;
        for (i64 r = lo; r < hi; ++r) {
            const u8* p = buf + starts[r];
            i64 m = ends[r] - starts[r];
            u8* row = out + r * rowbytes;
            if (bits == 2) {
                for (i64 j = 0; j < m; ++j) {
                    u8 b = p[reverse ? m - 1 - j : j];
                    u8 c = amap2[b];
                    if (c > 3) {
                        u8 v = amap[b];
                        local_miss |= v == 255;
                        i64 slot = nexc.fetch_add(1);
                        if (slot < exc_cap) {
                            exc[3 * slot] = (i32)r;
                            exc[3 * slot + 1] = (i32)j;
                            exc[3 * slot + 2] = (i32)v;
                        }
                        c = 0;
                    }
                    row[j >> 2] |= (u8)(c << ((j & 3) << 1));
                }
            } else if (bits == 4) {
                for (i64 j = 0; j < m; ++j) {
                    u8 v = amap[p[reverse ? m - 1 - j : j]];
                    local_miss |= v == 255;
                    row[j >> 1] |= (u8)((v & 15) << ((j & 1) << 2));
                }
            } else {
                for (i64 j = 0; j < m; ++j) {
                    u8 v = amap[p[reverse ? m - 1 - j : j]];
                    local_miss |= v == 255;
                    row[j] = v;
                }
            }
        }
        if (local_miss) miss.store(1);
    };
    if (threads <= 1 || nsel < 256) {
        work(0, nsel);
    } else {
        std::vector<std::thread> pool;
        i64 per = (nsel + threads - 1) / threads;
        for (int t = 0; t < threads; ++t) {
            i64 lo = t * per, hi = std::min(nsel, lo + per);
            if (lo < hi) pool.emplace_back(work, lo, hi);
        }
        for (auto& th : pool) th.join();
    }
    if (miss.load()) return -2;
    if (nexc.load() > exc_cap) return -1;
    return nexc.load();
}

}  // extern "C"
