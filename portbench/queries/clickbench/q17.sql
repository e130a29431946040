SELECT "UserID", "SearchPhrase", COUNT(*) AS c FROM hits
GROUP BY "UserID", "SearchPhrase" LIMIT 10
